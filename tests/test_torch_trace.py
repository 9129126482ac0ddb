"""The port's spans and counters (utils/trace.py) on the CPU, both curves:
nothing recorded and no profiler range entered without a profiler, the
same window sums with one; under torch.profiler every stage span of a
compute_msm once a stage (the copy once for the points and once for the
scalars), in order, inside msm.api, on the calling thread, as host ops
and not user annotations; a batch's stage spans once a set; and the
finish-chain counter against a plan worked out by hand."""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import webgpu_msm_bls12_377_tpu_torch as port
from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import EDWARDS, G1, naive_msm
from webgpu_msm_bls12_377_tpu_torch.utils import trace

torch.set_num_threads(1)

CURVES = pytest.mark.parametrize("curve", ["bls12_377", "edwards_bls12"],
                                 ids=["", "ed"])
#: the stage spans of one compute_msm on the tree path, in order
STAGES = ["msm.prepare", "msm.copy", "msm.point_prep", "msm.copy",
          "msm.plan", "msm.smvp", "msm.horner"]


def case(curve, scalars):
    """(entry, affine points (i + 1) G, scalars, the oracle's result)."""
    if curve == "bls12_377":
        pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, i + 1)
               for i in range(len(scalars))]
        return (port.compute_msm, [crv.g1_to_affine(p) for p in pts], scalars,
                crv.g1_to_affine(naive_msm(pts, scalars, G1)))
    pts = [crv.ed_scalar_mult(crv.ED_GENERATOR, i + 1)
           for i in range(len(scalars))]
    return (port.compute_msm_edwards, [crv.ed_to_affine(p) for p in pts],
            scalars, crv.ed_to_affine(naive_msm(pts, scalars, EDWARDS)))


def scalars(n=16):
    return [(0x1F3D5B79 * (i + 3)) ** 7 % (1 << 253) for i in range(n)]


def engine(curve, **kw):
    return CuzkMsmEngine(CurveId(curve), chunk_size=4, num_bpr_threads=4,
                         smvp_mode="tree", tree_finish=2, autotune=False,
                         device="cpu", **kw)


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    """Empty totals before and after; no tuning table; compute_msm takes
    the hybrid tree at these tiny n."""
    monkeypatch.setenv("MSM_AUTOTUNE_DIR", str(tmp_path))
    monkeypatch.setattr(CuzkMsmEngine, "_select_smvp",
                        lambda self, chunk, n: "tree")
    trace.reset()
    yield
    trace.reset()


def spans_of(prof):
    """The msm.* host events of a profile, in start order."""
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("msm.")]
    return sorted(events, key=lambda e: e.start_ns())


@CURVES
def test_nothing_recorded_without_a_profiler(curve, monkeypatch):
    fn, aff, sc, want = case(curve, scalars())
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(trace, "_range", Counting)
    got = fn(aff, sc, device="cpu")
    assert (got["x"], got["y"]) == want
    assert entered == [] and trace.totals() == {} and trace.counters() == {}
    assert not trace.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.recording()
        traced = fn(aff, sc, device="cpu")
    assert traced == got
    assert entered == ["msm.api"] + STAGES
    assert trace.counters()["msm.finish_chain"][1] == 1


@CURVES
def test_window_sums_are_the_same_with_a_profiler(curve):
    _, aff, sc, _ = case(curve, scalars())
    eng = engine(curve)
    prepared = eng._prepare_points(aff), eng._prepare_scalars(sc)
    plain = eng.msm_device(*prepared, 4)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = eng.msm_device(*prepared, 4)
    assert torch.equal(plain, traced)


@CURVES
def test_stage_spans_in_order_inside_the_call(curve):
    fn, aff, sc, want = case(curve, scalars())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(1).add_(1)  # an op of the calling thread
        got = fn(aff, sc, device="cpu")
    assert (got["x"], got["y"]) == want
    spans = spans_of(prof)
    assert [e.name() for e in spans] == ["msm.api"] + STAGES
    api, stages = spans[0], spans[1:]
    caller = next(e.start_thread_id() for e in
                  prof.profiler.kineto_results.events()
                  if e.name() == "aten::add_")
    assert {e.start_thread_id() for e in spans} == {caller}
    for e in stages:
        assert api.start_ns() <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= (api.start_ns()
                                                  + api.duration_ns())
    ends = [e.start_ns() + e.duration_ns() for e in stages]
    assert all(a <= b.start_ns() for a, b in zip(ends, stages[1:]))
    # host ops, which the profiler does not copy onto the device timeline
    assert not any(e.is_user_annotation() for e in spans)
    totals = trace.totals()
    assert totals["msm.copy"][0] == 2
    assert all(totals[name][0] == 1 for name in set(STAGES) - {"msm.copy"})


@CURVES
def test_a_batch_has_a_plan_span_a_set(curve):
    _, aff, sc, _ = case(curve, scalars(8))
    sets = [sc, sc[::-1], [s // 3 for s in sc]]
    eng = engine(curve)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = eng.compute_msm_batch(aff, sets)
    assert got == [eng.compute_msm(aff, s) for s in sets]
    names = [e.name() for e in spans_of(prof)]
    assert {name: names.count(name) for name in set(names)} == {
        "msm.prepare": 1, "msm.copy": 4, "msm.point_prep": 1, "msm.plan": 3,
        "msm.smvp": 3, "msm.horner": 3, "msm.set": 3}
    assert trace.counters()["msm.finish_chain"][1] == 3
    assert "msm.key_bytes" not in trace.counters()


@CURVES
def test_finish_chain_is_the_longest_level_k_bucket(curve):
    """11 points share one scalar and 5 have scalar 0: in every window
    where that scalar's digit is not 0 its bucket holds 11 entries, every
    other bucket none (a 0 digit joins no bucket).  Two tree levels halve
    it twice, rounding up: 11 -> 6 -> 3 nodes, one piece, the finish's
    chain; no bucket is cut."""
    s = (1 << 252) + 0x123456789ABCDEF
    fn, aff, sc, want = case(curve, [s] * 11 + [0] * 5)
    eng = engine(curve)
    with profile(activities=[ProfilerActivity.CPU]):
        got = eng.compute_msm(aff, sc)
    assert (got["x"], got["y"]) == want
    assert trace.counters() == {
        "msm.finish_chain": (math.ceil(math.ceil(11 / 2) / 2), 1),
        "msm.finish_split": (0, 1),
        "msm.fold_lone": (0, 1)}


@CURVES
def test_finish_counters_of_a_bucket_cut_into_pieces(curve):
    """300 points share one scalar: its bucket holds 300 entries in every
    window where its digit is not 0, 75 nodes after two levels, cut into
    pieces of at most PIECE nodes.  The longest chain a thread walks is a
    whole piece and the fold's levels of those pieces; the buckets cut are
    those windows' buckets, each of few enough pieces for one thread of
    the fold."""
    from webgpu_msm_bls12_377_tpu_torch.ops import decompose
    from webgpu_msm_bls12_377_tpu_torch.ops.smvp_stream import FOLD_LONE, PIECE

    s = (1 << 252) + 0x123456789ABCDEF
    fn, aff, sc, want = case(curve, [s] * 300)
    eng = engine(curve)
    windows = decompose.num_windows_for(4)
    words = torch.tensor([[(s >> (32 * i)) & 0xFFFFFFFF for i in range(8)]],
                         dtype=torch.int64).T
    digits = decompose.decompose_scalars_signed(words, 4, windows)
    # digits are stored shifted by 2^(chunk - 1): 8 is the digit 0
    cut = int((digits[:, 0] != 8).sum())
    with profile(activities=[ProfilerActivity.CPU]):
        got = eng.compute_msm(aff, sc)
    assert (got["x"], got["y"]) == want
    assert 0 < cut < windows
    pieces = math.ceil(75 / PIECE)
    assert 1 < pieces <= FOLD_LONE
    assert trace.counters() == {
        "msm.finish_chain": (PIECE + math.ceil(math.log2(pieces)), 1),
        "msm.finish_split": (cut, 1),
        "msm.fold_lone": (cut, 1)}


def test_names_are_listed_and_checked():
    assert len(set(trace.SPANS + trace.COUNTERS)) == len(trace.SPANS
                                                         + trace.COUNTERS)
    assert all(n.startswith("msm.") and not n.startswith("msm_bench.")
               for n in trace.SPANS + trace.COUNTERS)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            trace.span("msm.unlisted")
        with pytest.raises(ValueError):
            trace.count("msm.unlisted", 1)
        trace.count("msm.finish_chain", torch.tensor(7, dtype=torch.int32))
        trace.count("msm.finish_chain", 2)
        with trace.span("msm.horner"):
            pass
    assert trace.counters() == {"msm.finish_chain": (9, 2)}
    assert trace.totals()["msm.horner"][0] == 1
    # outside a profiler an unlisted name costs the flag check alone
    trace.count("msm.unlisted", 1)
    with trace.span("msm.unlisted"):
        pass


def test_threads_lose_no_update(monkeypatch):
    """Spans and counts from more threads than cores, switching often, all
    counted.  (A profiler records only the thread that started it, and
    torch's flag is per thread, so the flag and the range are stood in
    for here.)"""
    import contextlib
    import os
    import sys
    import threading

    monkeypatch.setattr(trace, "_on", lambda: True)
    monkeypatch.setattr(trace, "_range",
                        lambda name: contextlib.nullcontext())
    threads, each = 2 * (os.cpu_count() or 1) + 2, 200

    def work():
        for _ in range(each):
            with trace.span("msm.plan"):
                trace.count("msm.finish_chain", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert trace.totals()["msm.plan"][0] == threads * each
    assert trace.counters()["msm.finish_chain"] == (threads * each,
                                                    threads * each)
