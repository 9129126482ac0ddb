"""Timing (timing.py), the build directories and keys (build_cache.py)
and the spans and counters a profiler reads (trace.py) of the port."""
