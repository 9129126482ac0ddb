"""What the program records of itself in a traced run: the port's spans
and counters (webgpu_msm_bls12_377_tpu_torch/utils/trace.py), which it
keeps only while a profiler records, so over the traced window alone.
Read after the window; None where the program records nothing of the
name (a checkout without that module, or a span or counter the window
never reached).

The totals are the process's, and nothing resets them when a window
starts: they read one window only because run.py traces one window a
process and no profiler records during set-up.  A harness that traced
two windows in one process would call the port's trace.reset() between
them."""

from __future__ import annotations


def _trace():
    try:
        from webgpu_msm_bls12_377_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def span_ms_per_msm(reading, name: str) -> float | None:
    """Host milliseconds inside span `name`, per MSM of the window."""
    t = _trace()
    got = t.totals().get(name) if t else None
    return None if got is None else got[1] * 1e3 / reading.msms


def counter_mean(name: str) -> float | None:
    """Counter `name`'s values summed over the window, per value counted."""
    t = _trace()
    got = t.counters().get(name) if t else None
    return None if got is None else got[0] / got[1]
