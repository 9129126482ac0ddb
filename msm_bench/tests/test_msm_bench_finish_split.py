"""The reader of the program's msm.finish_split counter (the buckets a
packed finish cut into pieces): a mean over the finishes counted, None
where nothing was counted, and in a traced tiny run of a cell."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msm_bench import run, trace
from msm_bench.metrics import finish_split_per_msm

port_trace = pytest.importorskip("webgpu_msm_bls12_377_tpu_torch.utils.trace")


def blank():
    return trace.Reading(msms=1, call_ms=[], launches=0, kernel_s={},
                         copy_s={}, busy_s=0.0, window_s=1.0, layer_maps={})


@pytest.fixture
def fresh():
    port_trace.reset()
    yield
    port_trace.reset()


def test_reads_the_mean_of_the_counted_finishes(fresh):
    with profile(activities=[ProfilerActivity.CPU]):
        for v in (2_900, 3_000, 0):
            port_trace.count("msm.finish_split", torch.tensor([v]))
    assert finish_split_per_msm.read(blank()) == pytest.approx(5_900 / 3)


def test_reads_none_where_nothing_was_counted(fresh):
    with profile(activities=[ProfilerActivity.CPU]):
        with port_trace.span("msm.smvp"):
            pass
    assert finish_split_per_msm.read(blank()) is None


def test_traced_tiny_run_reports_it(tiny, fresh, monkeypatch):
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine

    # the cells' path at 2^18, the hybrid tree, at this tiny n: no bucket
    # reaches the pieces' length
    monkeypatch.setattr(CuzkMsmEngine, "_select_smvp",
                        lambda self, chunk, n: "tree")
    out = run.run_cell(tiny("ed_2p18.zipf", n=32), 2**31 + 97, 0.2, True,
                       device="cpu", cache=None)
    assert out["correct"]
    got = out["metrics"]["finish_split_per_msm"]
    assert got == {"value": 0.0, "unit": "buckets/finish"}
