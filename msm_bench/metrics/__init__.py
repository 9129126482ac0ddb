"""Per-layer metrics: metrics/<name>.py defines read(reading) -> the
number, or None where the traced run holds nothing to read it from
(msm_bench/trace.py: Reading)."""
