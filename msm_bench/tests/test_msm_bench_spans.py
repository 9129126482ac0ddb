"""The readers of what the program records of itself (program.py and the
metrics that use it), and trace.read over a trace that holds the port's
spans: they are host ops on the calling thread, so every device number
stays what it is without them and the idle gaps take their names."""

import sys
import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from msm_bench import cell as C
from msm_bench import run, trace
from msm_bench.metrics import (copy_host_ms_per_msm, device_idle_pct,
                               finish_chain_max, horner_ms_per_msm,
                               launches_per_msm, plan_host_ms_per_msm)

port_trace = pytest.importorskip("webgpu_msm_bls12_377_tpu_torch.utils.trace")

CALLER, OTHER = 11, 12
NEW = {"msm.copy": copy_host_ms_per_msm, "msm.plan": plan_host_ms_per_msm,
       "msm.horner": horner_ms_per_msm}


class Event:
    def __init__(self, name, start_us, end_us, device=False, tid=CALLER):
        self._name, self._tid = name, tid
        self._start, self._end = start_us * 1000, end_us * 1000
        self._type = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._name

    def device_type(self):
        return self._type

    def start_thread_id(self):
        return self._tid

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start


def call_events():
    """Two calls of 1 ms: launches, kernels of three layers, a copy, an
    op of another thread, and host time outside any op."""
    ev = []
    for c in (0, 1000):
        ev += [Event("msm_bench.call", c, c + 1000),
               Event("aten::copy_", c + 30, c + 60),
               Event("cudaMemcpyAsync", c + 40, c + 50),
               Event("Memcpy HtoD (Pinned -> Device)", c + 40, c + 140, True),
               Event("aten::sort", c + 200, c + 260),
               Event("cudaLaunchKernel", c + 210, c + 220),
               Event("void at::cub::RadixSortKernel<int>", c + 230, c + 330,
                     True),
               Event("cudaLaunchKernel", c + 400, c + 410),
               Event("packed_finish_kernel<13>", c + 420, c + 820, True),
               Event("cudaLaunchKernel", c + 830, c + 840),
               Event("stage1_kernel<13>", c + 850, c + 900, True),
               Event("aten::empty", c + 500, c + 700, tid=OTHER)]
    return ev


def program_spans():
    """The port's stage spans over the same calls, host ops of the
    calling thread, nested in msm.api."""
    ev = []
    for c in (0, 1000):
        ev += [Event("msm.api", c + 20, c + 980),
               Event("msm.copy", c + 20, c + 150),
               Event("msm.plan", c + 190, c + 340),
               Event("msm.smvp", c + 390, c + 845),
               Event("msm.horner", c + 910, c + 970)]
    return ev


def reading(events):
    return trace.read(events, 2, [1.0, 1.0], C.layer_maps())


def test_program_spans_change_no_device_number():
    base, spans = reading(call_events()), reading(call_events()
                                                  + program_spans())
    for field in ("msms", "launches", "kernel_s", "copy_s", "busy_s",
                  "window_s"):
        assert getattr(spans, field) == getattr(base, field), field
    for layer in C.layer_maps():
        assert spans.layer_s(layer) == base.layer_s(layer)
    assert spans.breakdown["device_ops"] == base.breakdown["device_ops"]
    for m in (device_idle_pct, launches_per_msm):
        assert m.read(spans) == m.read(base)
    assert base.launches == 6 and not any(
        k.startswith("msm.") for k in spans.kernel_s)


def test_idle_gaps_take_the_innermost_span():
    base = dict(reading(call_events()).breakdown["idle_gaps"])
    named = dict(reading(call_events() + program_spans())
                 .breakdown["idle_gaps"])
    assert sum(named.values()) == pytest.approx(sum(base.values()))
    assert base[trace.OUTSIDE] > 0
    # outside any op: 20 us before msm.api starts and after it ends
    assert named[trace.OUTSIDE] == pytest.approx(2 * 40e-6)
    # the card idles from 900 to 1000 us of each call; the Horner's span
    # runs from 910 to 970
    assert named["msm.horner"] == pytest.approx(2 * 60e-6)
    assert {"msm.api", "msm.plan", "msm.smvp"} <= set(named)


def blank(msms=4):
    return trace.Reading(msms=msms, call_ms=[], launches=0, kernel_s={},
                         copy_s={}, busy_s=0.0, window_s=1.0, layer_maps={})


@pytest.fixture
def fresh():
    port_trace.reset()
    yield
    port_trace.reset()


def test_new_metrics_read_hand_made_spans(fresh):
    with profile(activities=[ProfilerActivity.CPU]):
        for name, ms in (("msm.copy", 8), ("msm.plan", 4), ("msm.horner", 2)):
            for _ in range(2):
                with port_trace.span(name):
                    time.sleep(ms / 1e3)
        for v in (16, 17):
            port_trace.count("msm.finish_chain", torch.tensor(v))
    totals = port_trace.totals()
    for name, m in NEW.items():
        assert m.read(blank()) == pytest.approx(totals[name][1] * 1e3 / 4)
    assert 4.0 <= copy_host_ms_per_msm.read(blank()) < 8.0
    assert 1.0 <= horner_ms_per_msm.read(blank()) < 2.0
    assert finish_chain_max.read(blank()) == 16.5


def test_new_metrics_read_none_where_nothing_was_recorded(fresh,
                                                          monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        with port_trace.span("msm.smvp"):
            pass
    for m in list(NEW.values()) + [finish_chain_max]:
        assert m.read(blank()) is None
    # a checkout whose program has no such module
    import webgpu_msm_bls12_377_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, port_trace.__name__, None)
    with profile(activities=[ProfilerActivity.CPU]):
        with port_trace.span("msm.copy"):
            pass
    assert copy_host_ms_per_msm.read(blank()) is None


def test_traced_tiny_run_reports_the_new_metrics(tiny, fresh, monkeypatch):
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine

    # the cells' path at 2^18, the hybrid tree, at this tiny n
    monkeypatch.setattr(CuzkMsmEngine, "_select_smvp",
                        lambda self, chunk, n: "tree")
    out = run.run_cell(tiny("ed_2p18.zipf", n=32), 2**31 + 91, 0.2, True,
                       device="cpu", cache=None)
    assert out["correct"]
    got = out["metrics"]
    for name in ("copy_host_ms_per_msm", "plan_host_ms_per_msm",
                 "horner_ms_per_msm", "finish_chain_max"):
        assert got[name]["value"] > 0, name
    assert got["finish_chain_max"]["unit"] == "adds/finish"
    # a chain of the finish is at most a quarter of the points, rounded up
    assert got["finish_chain_max"]["value"] <= 8
