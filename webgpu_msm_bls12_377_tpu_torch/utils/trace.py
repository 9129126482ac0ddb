"""The port's spans and counters, recorded only while a torch profiler
records on the calling thread (torch's own flag,
torch._C._autograd._profiler_enabled, which is per thread, as the
profiler's host events are).

- span(name): a context manager around one stage of an MSM.  While a
  profiler records it opens a host range of that name in the profiler's
  trace (a host op of the calling thread, on the clock of the card's
  kernel and copy events, so that a trace reader can put the card's idle
  time down to the stage the host was in) and adds the range's host time
  to the span's total.  The range is a plain host op and not a user
  annotation (torch.profiler.record_function), which the profiler would
  also copy onto the device timeline, where it would read as device time.
  With no profiler recording a span costs one flag check.
- count(name, value): adds a value to a counter while a profiler records,
  and does nothing otherwise.  A value may be a tensor on the card: it
  stays there until counters() reads it, so that counting adds no host
  wait to a call.
- totals() and counters() read what was recorded since the process
  started or since reset(): read them after the traced calls, never on a
  call's path (counters() copies device values to the host).

Every name is in SPANS or COUNTERS; all start with "msm.".
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

#: the stages of one MSM, in the order a call runs them (models/cuzk.py)
SPANS = (
    "msm.api",  # compute_msm / compute_msm_edwards, the engine they build
    "msm.prepare",  # wire formats to host words, and their checks
    "msm.copy",  # words_to_device: the pinned fill and the copies' enqueue
    "msm.point_prep",  # kernel 1's point prep into the path's table
    "msm.plan",  # digits, bucket plan, BPR order and the path's own plan
    "msm.smvp",  # the path's bucket sums, gathered into BPR order
    "msm.horner",  # the host Horner and the affine conversion
    # a batch's one set, resident or not: its scalar copy, then its plan,
    # SMVP, BPR and exit enqueued (a legacy batch's set: its compute_msm)
    "msm.set",
    # ResidentBases' set-up: the points' check, copy and prep, once
    "msm.bases_init",
)
#: of one packed finish (ops/smvp_stream.py:packed_finish): the longest
#: chain of dependent adds one thread walks (the longest piece, then the
#: fold's levels of the bucket with the most pieces), and the buckets cut
#: into two or more pieces; of each set a resident call runs: the device
#: bytes of the table its ResidentBases holds
COUNTERS = ("msm.finish_chain", "msm.finish_split", "msm.key_bytes")

_on = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_NONE = contextlib.nullcontext()
_lock = threading.Lock()
_spans: dict[str, list[int]] = {}  # name -> [ranges, host ns]
_counts: dict[str, list] = {}  # name -> values counted


def recording() -> bool:
    """True while a torch profiler records this thread."""
    return _on()


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        if name not in SPANS:
            raise ValueError(f"unknown span {name!r}")
        self.name = name

    def __enter__(self):
        self.rf = _range(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        self.rf.__exit__(*exc)
        with _lock:
            tot = _spans.setdefault(self.name, [0, 0])
            tot[0] += 1
            tot[1] += ns


def span(name: str):
    """A span of one stage: a range of the profiler's trace while one
    records, else nothing."""
    return _Span(name) if _on() else _NONE


def count(name: str, value) -> None:
    """Add value (an int or a one-element tensor, left where it lies) to
    counter `name` while a profiler records."""
    if not _on():
        return
    if name not in COUNTERS:
        raise ValueError(f"unknown counter {name!r}")
    with _lock:
        _counts.setdefault(name, []).append(value)


def totals() -> dict[str, tuple[int, float]]:
    """Span name -> (ranges recorded, their host seconds), for the spans
    that recorded any."""
    with _lock:
        return {k: (n, ns / 1e9) for k, (n, ns) in _spans.items()}


def counters() -> dict[str, tuple[int, int]]:
    """Counter name -> (the sum of its values, values counted), for the
    counters that counted any; device values are copied to the host
    here."""
    with _lock:
        counts = {k: list(v) for k, v in _counts.items() if v}
    return {k: (sum(int(x) for x in v), len(v)) for k, v in counts.items()}


def reset() -> None:
    """Forget every span's total and every counter's values."""
    with _lock:
        _spans.clear()
        _counts.clear()
