"""Scalar generators: gen/<kind>.py, named by the traffic's `kind`,
defines scalar_sets(traffic, config, seed) -> the pool of (n, 8) uint32
word arrays (32-byte little-endian scalars), the same for the same seed."""
