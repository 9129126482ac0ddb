"""The resident-bases entry (api.multi_scalar_mult_init,
multi_scalar_mult; models/cuzk.py:ResidentBases) on the CPU at small n,
both curves: several calls on one handle against the plain reference
(reference/msm.py, Python integers) on every path reachable at small n,
word for word compute_msm_batch's window sums, the handle's own copy of
the points, the refusals, the spans and the key counter, the device pool's
one point prep a device, and (marked cuda, skipped without a card) the
entry at 2^18 against compute_msm on the card.  Imports no JAX."""

import gc
import random
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import webgpu_msm_bls12_377_tpu_torch as port
from webgpu_msm_bls12_377_tpu_torch.models import cuzk
from webgpu_msm_bls12_377_tpu_torch.models.cuzk import (
    CuzkMsmEngine,
    ResidentBases,
)
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import EDWARDS, G1, naive_msm
from webgpu_msm_bls12_377_tpu_torch.utils import trace

torch.set_num_threads(1)

CURVES = pytest.mark.parametrize("curve", ["bls12_377", "edwards_bls12"],
                                 ids=["", "ed"])
N = 16
#: (smvp_mode, chunk_size): every path small n reaches, forced
PATHS = pytest.mark.parametrize("mode,chunk", [
    ("fused", 4), ("legacy", 4), ("tree", 9), ("stream", 9)])


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    """No tuning table; empty span totals and counters before and after."""
    monkeypatch.setenv("MSM_AUTOTUNE_DIR", str(tmp_path))
    trace.reset()
    yield
    trace.reset()


class Case:
    """n points k_i G, their wire bytes, and scalar sets with the
    reference's result of each."""

    def __init__(self, curve: str, n: int = N, sets: int = 4):
        rng = random.Random(f"resident-{curve}-{n}")
        self.curve = CurveId(curve)
        if self.curve == CurveId.BLS12_377:
            mult, aff, self.group, cb = (crv.g1_scalar_mult, crv.g1_to_affine,
                                         G1, 48)
            gen = crv.G1_GENERATOR
        else:
            mult, aff, self.group, cb = (crv.ed_scalar_mult, crv.ed_to_affine,
                                         EDWARDS, 32)
            gen = crv.ED_GENERATOR
        self.to_affine = aff
        self.pts = [mult(gen, rng.randrange(1, 1 << 40)) for _ in range(n)]
        self.aff = [aff(p) for p in self.pts]
        self.wire = b"".join(x.to_bytes(cb, "little") + y.to_bytes(cb, "little")
                             for x, y in self.aff)
        pool = [rng.randrange(1 << 253) for _ in range(3)]
        self.sets = [[rng.randrange(1 << 253) for _ in range(n)]
                     for _ in range(sets - 1)]
        # a duplicate-heavy set: long buckets
        self.sets.append([rng.choice(pool) for _ in range(n)])

    def want(self, scalars):
        return self.to_affine(naive_msm(self.pts, scalars, self.group))

    def engine(self, **kw):
        opts = dict(num_bpr_threads=4, autotune=False, device="cpu")
        return CuzkMsmEngine(self.curve, **{**opts, **kw})


def pairs(results):
    return [(r["x"], r["y"]) for r in results]


@CURVES
@PATHS
def test_calls_on_one_handle_match_the_reference(curve, mode, chunk):
    """Two calls of two sets each on one handle, on each path: every
    result is the reference's, in order, and the path and window are the
    ones fixed at init."""
    c = Case(curve)
    bases = ResidentBases(c.engine(smvp_mode=mode, chunk_size=chunk), c.aff)
    assert (bases.path, bases.chunk_size, bases.n) == (mode, chunk, N)
    for call in (c.sets[:2], c.sets[2:]):
        assert pairs(port.multi_scalar_mult(bases, call)) == [
            c.want(s) for s in call]


@CURVES
def test_public_entry_from_wire_bytes_and_word_arrays(curve):
    """multi_scalar_mult_init at its defaults (the path the static policy
    picks at this n) from wire bytes and from a word array, and sets in
    each of compute_msm's forms: ints, wire bytes, an (8, n) word array."""
    from webgpu_msm_bls12_377_tpu_torch.ops.convert import ints_to_words

    c = Case(curve)
    cb = 48 if c.curve == CurveId.BLS12_377 else 32
    words = np.stack([ints_to_words([x for x, _ in c.aff], cb // 4),
                      ints_to_words([y for _, y in c.aff], cb // 4)])
    s0, s1, s2 = c.sets[:3]
    sets = [s0, b"".join(s.to_bytes(32, "little") for s in s1),
            ints_to_words(s2, 8)]
    want = [c.want(s) for s in (s0, s1, s2)]
    for points in (c.wire, words):
        bases = port.multi_scalar_mult_init(points, curve=curve, device="cpu")
        assert bases.path in ("fused", "legacy") and bases.chunk_size == 4
        assert pairs(port.multi_scalar_mult(bases, sets)) == want


@CURVES
@pytest.mark.parametrize("mode,chunk", [("fused", 4), ("stream", 9)])
def test_window_sums_are_compute_msm_batch_word_for_word(curve, mode, chunk,
                                                         monkeypatch):
    """The same engine's compute_msm_batch and a resident call on the same
    inputs: the same (sets, rows, windows) window sums before the Horner,
    and the same results."""
    c = Case(curve, sets=2)
    eng = c.engine(smvp_mode=mode, chunk_size=chunk)
    sums = []
    real = CuzkMsmEngine._batch_finish

    def kept(self, coords, chunk_size):
        sums.append(torch.stack(coords))
        return real(self, coords, chunk_size)

    monkeypatch.setattr(CuzkMsmEngine, "_batch_finish", kept)
    batch = eng.compute_msm_batch(c.wire, c.sets)
    resident = ResidentBases(eng, c.wire).run(c.sets)
    assert resident == batch
    assert len(sums) == 2 and torch.equal(sums[0], sums[1])


@CURVES
def test_the_handle_keeps_its_own_copy(curve):
    """The caller's buffer (a bytearray, a word array) overwritten after
    init changes no result."""
    c = Case(curve)
    buf = bytearray(c.wire)
    bases = port.multi_scalar_mult_init(buf, curve=curve, device="cpu")
    buf[:] = bytes(len(buf))
    words = np.frombuffer(bytearray(c.wire), dtype=np.uint32).copy()
    words = np.ascontiguousarray(words.reshape(N, 2, -1).transpose(1, 2, 0))
    by_words = port.multi_scalar_mult_init(words, curve=curve, device="cpu")
    words[:] = 0
    want = [c.want(s) for s in c.sets[:2]]
    assert pairs(port.multi_scalar_mult(bases, c.sets[:2])) == want
    assert pairs(port.multi_scalar_mult(by_words, c.sets[:2])) == want


@CURVES
def test_refusals_come_before_any_set_runs(curve):
    """A set of the wrong length, a scalar of 2^253 and an empty batch are
    refused before any set is enqueued; no points, and a closed handle,
    are refused too."""
    c = Case(curve)
    bases = ResidentBases(c.engine(smvp_mode="fused", chunk_size=4), c.aff)
    good = c.sets[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CuzkMsmEngine, "_batch_sets",
                   lambda *a: pytest.fail("a set ran"))
        with pytest.raises(ValueError, match="mismatch"):
            bases.run([good, good[:-1]])
        with pytest.raises(ValueError, match="2\\^253"):
            bases.run([good, [1 << 253] + good[1:]])
        with pytest.raises(ValueError, match="empty batch"):
            port.multi_scalar_mult(bases, [])
        with pytest.raises(ValueError, match="empty MSM"):
            port.multi_scalar_mult_init([], curve=curve, device="cpu")
    with bases:
        assert pairs(bases.run([good])) == [c.want(good)]
    with pytest.raises(ValueError, match="closed"):
        bases.run([good])


def test_dropping_the_last_reference_frees_the_table():
    c = Case("edwards_bls12")
    bases = port.multi_scalar_mult_init(c.wire, curve="edwards_bls12",
                                        device="cpu")
    table = weakref.ref(bases._key.table)
    assert table() is not None
    del bases
    gc.collect()
    assert table() is None
    closed = port.multi_scalar_mult_init(c.wire, curve="edwards_bls12",
                                        device="cpu")
    table = weakref.ref(closed._key.table)
    closed.close()
    gc.collect()
    assert table() is None


@CURVES
def test_spans_and_the_key_counter_only_while_a_profiler_records(curve):
    """Without a profiler nothing is recorded; with one, init is one
    msm.bases_init span, every set of a resident call one msm.set span and
    one msm.key_bytes value (the table's bytes), and a compute_msm_batch's
    sets msm.set spans and no key bytes."""
    c = Case(curve)
    eng = c.engine(smvp_mode="legacy", chunk_size=4)
    bases = ResidentBases(eng, c.wire)
    bases.run(c.sets[:2])
    assert trace.totals() == {} and trace.counters() == {}
    table = bases._key.table
    assert bases.key_bytes == table.numel() * 4 == 2 * N * 32 * 4
    with profile(activities=[ProfilerActivity.CPU]):
        traced = ResidentBases(eng, c.wire)
        traced.run(c.sets[:2])
        traced.run(c.sets[3:])
    totals = trace.totals()
    assert totals["msm.bases_init"][0] == 1
    assert totals["msm.set"][0] == 3
    assert trace.counters()["msm.key_bytes"] == (3 * bases.key_bytes, 3)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        eng.compute_msm_batch(c.wire, c.sets[:2])
    assert trace.totals()["msm.set"][0] == 2
    assert "msm.key_bytes" not in trace.counters()
    assert "msm.bases_init" not in trace.totals()


@CURVES
def test_a_pool_preps_once_a_device(curve, monkeypatch):
    """compute_msm_batch(devices=["cpu", "cpu"]): the members share one
    device, so one point prep serves both, and the results are those
    without a pool."""
    c = Case(curve, sets=2)
    eng = c.engine(smvp_mode="stream", chunk_size=9)
    alone = eng.compute_msm_batch(c.wire, c.sets)
    preps = []
    real = cuzk.point_prep
    monkeypatch.setattr(cuzk, "point_prep",
                        lambda *a: preps.append(1) or real(*a))
    assert eng.compute_msm_batch(c.wire, c.sets, devices=["cpu", "cpu"]) == alone
    assert preps == [1]
    assert [c.want(s) for s in c.sets] == pairs(alone)


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
@CURVES
def test_resident_on_the_card_at_2p18(curve):
    """2^18 points k_i G made on the card, two calls of two uniform sets on
    one handle against compute_msm on the card, set by set; the sets'
    stage makes no host wait (PyTorch's sync debug mode raises on one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    from webgpu_msm_bls12_377_tpu_torch.harness.testdata import points_from_ks

    n = 1 << 18
    rng = np.random.default_rng(18)
    ks = rng.integers(1, 1 << 32, size=(8, n), dtype=np.uint32)
    ks[7] &= 0x00FFFFFF  # below either group's order
    points = points_from_ks(curve, ks)
    sets = []
    for _ in range(4):
        s = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint32)
        s[7] &= 0x1FFFFFFF
        sets.append(s)
    entry = (port.compute_msm if CurveId(curve) == CurveId.BLS12_377
             else port.compute_msm_edwards)
    want = [entry(points, s) for s in sets]
    real = CuzkMsmEngine._batch_sets

    def strict(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CuzkMsmEngine, "_batch_sets", strict)
        with port.multi_scalar_mult_init(points, curve=curve) as bases:
            assert bases.path == "tree"
            got = (port.multi_scalar_mult(bases, sets[:2])
                   + port.multi_scalar_mult(bases, sets[2:]))
    assert got == want
