"""Timing (timing.py) and the build directories and keys (build_cache.py)
of the port."""
