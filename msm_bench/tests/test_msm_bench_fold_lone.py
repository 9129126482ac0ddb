"""The reader of fold_lone_share: the program's msm.fold_lone counter (the
cut buckets a finish's fold summed on one thread) over its
msm.finish_split counter (the buckets cut), None where either was not
counted or nothing was cut, and a traced tiny run of a cell."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msm_bench import run, trace
from msm_bench.metrics import fold_lone_share

port_trace = pytest.importorskip("webgpu_msm_bls12_377_tpu_torch.utils.trace")


def blank():
    return trace.Reading(msms=1, call_ms=[], launches=0, kernel_s={},
                         copy_s={}, busy_s=0.0, window_s=1.0, layer_maps={})


@pytest.fixture
def fresh():
    port_trace.reset()
    yield
    port_trace.reset()


def test_reads_the_share_of_the_two_counters(fresh):
    with profile(activities=[ProfilerActivity.CPU]):
        for cut, lone in ((2_212, 1_800), (2_200, 1_790), (2_224, 1_810)):
            port_trace.count("msm.finish_split", torch.tensor([cut]))
            port_trace.count("msm.fold_lone", torch.tensor(lone))
    assert fold_lone_share.read(blank()) == pytest.approx(5_400 / 6_636)


@pytest.mark.parametrize("counted", [(), ("msm.finish_split",),
                                     ("msm.fold_lone",)])
def test_reads_none_where_a_counter_is_missing(fresh, counted):
    with profile(activities=[ProfilerActivity.CPU]):
        for name in counted:
            port_trace.count(name, torch.tensor([3]))
    assert fold_lone_share.read(blank()) is None


def test_reads_none_where_nothing_was_cut(fresh):
    with profile(activities=[ProfilerActivity.CPU]):
        port_trace.count("msm.finish_split", torch.tensor([0]))
        port_trace.count("msm.fold_lone", torch.tensor(0))
    assert fold_lone_share.read(blank()) is None


def test_traced_tiny_run_leaves_it_out_where_nothing_is_cut(tiny, fresh,
                                                            monkeypatch):
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine

    # the cells' path at 2^18, the hybrid tree, at this tiny n: no bucket
    # reaches the pieces' length, so the finish counts no cut bucket
    monkeypatch.setattr(CuzkMsmEngine, "_select_smvp",
                        lambda self, chunk, n: "tree")
    out = run.run_cell(tiny("ed_2p18.zipf", n=32), 2**31 + 123, 0.2, True,
                       device="cpu", cache=None)
    assert out["correct"]
    assert "fold_lone_share" not in out["metrics"]
    assert out["metrics"]["finish_split_per_msm"]["value"] == 0.0
