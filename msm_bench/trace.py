"""The traced run's reading: torch.profiler (CUPTI) over the whole window,
reduced to what the per-layer metrics read (Reading).

- Device time: the profiler's device events, split into kernels and
  copies ("Memcpy ...", "Memset ..."); a kernel belongs to the layer whose
  map (layers/<name>.json) lists an identifier of its name, else to the
  map whose kernels are "rest" (PyTorch's own kernels).
- Launches: the host's kernel-launch calls (cudaLaunchKernel and kin).
- Window: from the first traced call's start to the last one's end (the
  harness's "msm_bench.call" ranges); busy_s the union of device events
  within it.
- Idle gaps: the window's device-idle time on a 10 us grid, by the
  innermost host operation of the calling thread at each point
  ("host_Python_outside_any_torch_op" where there is none).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re

import numpy as np

SPAN = "msm_bench.call"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
GRID_NS = 10_000
OUTSIDE = "host_Python_outside_any_torch_op"
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


@dataclasses.dataclass
class Reading:
    msms: int
    call_ms: list[float]
    launches: int
    kernel_s: dict[str, float]  # device seconds by kernel name
    copy_s: dict[str, float]  # device seconds by copy or set kind
    busy_s: float
    window_s: float
    layer_maps: dict[str, dict]
    least_s: float | None = None  # the yardstick's least time of all MSMs
    breakdown: dict | None = None

    def layer_s(self, layer: str) -> float:
        """Device seconds of the kernels that layers/<layer>.json maps."""
        owner = {}
        rest = None
        for name, m in self.layer_maps.items():
            if m["kernels"] == "rest":
                rest = name
            else:
                owner.update((k, name) for k in m["kernels"])
        total = 0.0
        for kernel, s in self.kernel_s.items():
            hit = next((owner[t] for t in _IDENT.findall(kernel) if t in owner),
                       rest)
            total += s if hit == layer else 0.0
        return total

    def h2d_s(self) -> float:
        return sum(s for k, s in self.copy_s.items() if "HtoD" in k)


def _interval(e) -> tuple[int, int]:
    """(start, end) in ns, from either generation of the event API."""
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        return start, start + e.duration_ns()
    start = e.start_us() * 1000
    return start, start + e.duration_us() * 1000


class Tracer:
    """The profiler over the window and a range around each call."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.prof = None
        if enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)

    def __enter__(self):
        if self.prof is not None:
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)

    def span(self):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN)

    def events(self):
        return self.prof.profiler.kineto_results.events()


def read(events, msms: int, call_ms: list[float],
         layer_maps: dict[str, dict]) -> Reading:
    from torch.autograd import DeviceType

    spans, device, host = [], [], []
    for e in events:
        name = e.name()
        if name.startswith("msm_bench."):
            if e.device_type() == DeviceType.CPU:
                spans.append((*_interval(e), e.start_thread_id()))
            continue
        if e.device_type() == DeviceType.CPU:
            host.append((*_interval(e), e.start_thread_id(), name))
        else:
            device.append((*_interval(e), name))
    if not spans:
        raise RuntimeError("the trace holds no call")
    w0 = min(s for s, _, _ in spans)
    w1 = max(t for _, t, _ in spans)
    caller = spans[0][2]
    kernel_s: dict[str, float] = {}
    copy_s: dict[str, float] = {}
    for s, t, name in device:
        if t <= w0 or s >= w1:
            continue
        book = copy_s if name.startswith(("Memcpy", "Memset")) else kernel_s
        book[name] = book.get(name, 0.0) + (t - s) / 1e9
    launches = sum(1 for s, _, _, name in host
                   if w0 <= s <= w1 and name.startswith(LAUNCHES))

    cells = max(1, -(-(w1 - w0) // GRID_NS))
    busy = np.zeros(cells, dtype=bool)
    busy_ns = 0
    cur0 = cur1 = None
    for s, t, _ in sorted(device):
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        busy[(s - w0) // GRID_NS:-(-(t - w0) // GRID_NS)] = True
        if cur1 is None or s > cur1:
            if cur1 is not None:
                busy_ns += cur1 - cur0
            cur0, cur1 = s, t
        else:
            cur1 = max(cur1, t)
    if cur1 is not None:
        busy_ns += cur1 - cur0

    labels = np.zeros(cells, dtype=np.int32)
    codes = {OUTSIDE: 0}
    for s, t, tid, name in sorted(host):
        if tid != caller or t <= w0 or s >= w1:
            continue
        code = codes.setdefault(name, len(codes))
        labels[max(0, (s - w0) // GRID_NS):-(-(t - w0) // GRID_NS)] = code
    idle = np.bincount(labels[~busy], minlength=len(codes)) * GRID_NS / 1e9
    names = sorted(codes, key=codes.get)
    gaps = sorted(((names[i], float(v)) for i, v in enumerate(idle) if v),
                  key=lambda kv: -kv[1])[:10]
    ops = sorted({**kernel_s, **copy_s}.items(), key=lambda kv: -kv[1])[:10]
    return Reading(
        msms=msms, call_ms=call_ms, launches=launches, kernel_s=kernel_s,
        copy_s=copy_s, busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9,
        layer_maps=layer_maps,
        breakdown={"device_ops": [[k[:100], v] for k, v in ops],
                   "idle_gaps": [[k[:100], v] for k, v in gaps]})
