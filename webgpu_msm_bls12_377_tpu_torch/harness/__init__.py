"""Bench and test inputs of the port: the JAX package's test-data layer
(harness/testdata.py), its seed schemes word for word, the points made on
the device."""
