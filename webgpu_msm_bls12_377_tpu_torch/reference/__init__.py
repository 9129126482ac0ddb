"""Plain-bigint oracles (the port's own copy; no JAX)."""
