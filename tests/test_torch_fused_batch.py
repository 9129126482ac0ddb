"""Port fused SMVP path, pure tree and batch mode against the JAX package
and the bigint oracle (CPU, plain PyTorch versions of every kernel).

Same shapes as tests/test_smvp_fused.py: N = 96, chunk 4 (64 windows of 8
buckets), inputs from random.Random seeds.  The JAX wide rows and
pre-gathered rows are carried into the port's layout with from_jax_rows
and compared as integers mod p.  Bucket sums are held against the JAX
legacy accumulate_buckets on the same plan: the JAX suite holds its fused
kernel bit-identical to that path (tests/test_smvp_fused.py), both add
with the canonical complete mixed add from the identity in entry order,
and canonical coordinates have one representation.  One slow test runs the
JAX fused kernel itself in interpret mode.  Every comparison is exact
equality of integers: no tolerance.
"""

import contextlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu.models import cuzk as jcuzk
from webgpu_msm_bls12_377_tpu.ops import buckets as jbuck
from webgpu_msm_bls12_377_tpu.ops import curve as jcurve
from webgpu_msm_bls12_377_tpu.ops import decompose as jdec
from webgpu_msm_bls12_377_tpu.ops import smvp_kernel as jfused
from webgpu_msm_bls12_377_tpu.ops import smvp_stream as jstream
from webgpu_msm_bls12_377_tpu.ops import smvp_tree as jtree
from webgpu_msm_bls12_377_tpu.params import CurveId as JCurveId
from webgpu_msm_bls12_377_tpu_torch.models import CuzkMsmEngine, cuzk
from webgpu_msm_bls12_377_tpu_torch.ops import bpr, buckets, decompose
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as fused
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream, smvp_tree
from webgpu_msm_bls12_377_tpu_torch.ops.convert import (
    from_jax_limbs,
    from_jax_rows,
    ints_to_words,
)
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import G1, naive_msm

# tiny tensors: one intra-op thread avoids oversubscribing the CPU
# beside the other test workers
torch.set_num_threads(1)

N = 96
CHUNK = 4
THREADS = 4
NWIN = decompose.num_windows_for(CHUNK)
H = 1 << (CHUNK - 1)
JG1 = jcurve.G1Ops()
W = 30  # JAX limbs per field element
HEAVY = [0x1234_5678_9ABC_DEF0] * N


@pytest.fixture(scope="module")
def case():
    rng = random.Random("fused-smvp")
    pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 60))
           for _ in range(N)]
    scalars = [rng.randrange(0, 1 << 253) for _ in range(N)]
    scalars[0], scalars[1] = 0, (1 << 253) - 1
    aff = [crv.g1_to_affine(p) for p in pts]
    pw = np.stack([ints_to_words([a[0] for a in aff], 12),
                   ints_to_words([a[1] for a in aff], 12)])
    return dict(pts=pts, aff=aff, scalars=scalars, pw=pw,
                sw=ints_to_words(scalars, 8),
                want=crv.g1_to_affine(naive_msm(pts, scalars, G1)))


@pytest.fixture(scope="module")
def plans(case):
    """The JAX table, plan and legacy bucket sums, and the port's table and
    plan from the same words."""
    jtable = jcuzk.mont_point_table(JG1.ctx, JG1, jnp.asarray(case["pw"]))
    jplan = jbuck.build_bucket_plan(
        jdec.decompose_scalars_signed(jnp.asarray(case["sw"]), CHUNK, NWIN),
        CHUNK)
    rounds = jbuck.round_class(int(np.asarray(jplan.lens).max()))
    legacy = jax.jit(lambda t, p: jbuck.accumulate_buckets(
        JG1, jbuck.table_to_rows(t), p, rounds))(jtable, jplan)
    table = from_jax_limbs(np.asarray(jtable).reshape(2 * W, N), montgomery=True)
    plan = buckets.build_bucket_plan(
        decompose.decompose_scalars_signed(
            torch.from_numpy(case["sw"].view(np.int32)), CHUNK, NWIN), CHUNK)
    assert np.array_equal(plan.sorted_vals.numpy(), np.asarray(jplan.sorted_vals))
    want = from_jax_limbs(np.concatenate([np.asarray(c) for c in legacy]),
                          montgomery=True)
    rows = fused.make_wide_rows(table)
    return dict(jtable=jtable, jplan=jplan, table=table, plan=plan, want=want,
                rows=rows, gathered=fused.pregather_signed(rows, plan.sorted_vals))


def engine(**kw):
    opts = dict(chunk_size=CHUNK, num_bpr_threads=THREADS, device="cpu")
    opts.update(kw)
    return CuzkMsmEngine(**opts)


# -- ops/smvp_kernel.py -------------------------------------------------------


def test_make_wide_rows_matches_jax(plans):
    jrows = jax.jit(lambda t: jfused.make_wide_rows(JG1, t))(plans["jtable"])
    assert plans["rows"].shape == (N, 39)
    assert torch.equal(plans["rows"], from_jax_rows(jrows, 3, montgomery=True))


def test_pregather_signed_matches_jax(plans):
    jrows = jfused.make_wide_rows(JG1, plans["jtable"])
    jgath = np.asarray(jfused.pregather_signed(JG1, jrows, plans["jplan"].sorted_vals))
    count = plans["plan"].sorted_vals.shape[0]
    assert jgath.shape == (count + jfused.R_TILE, jfused.CWP)
    got = plans["gathered"]
    assert got.shape == (count, fused.ROW_WORDS) and got.dtype == torch.int32
    assert torch.equal(got[:, :26], from_jax_rows(jgath[:count], 2, montgomery=True))
    assert not got[:, 26:].any()


def test_fused_buckets_match_jax_legacy(plans):
    """The plain form of kernel 8 on the whole plan: projective coordinates
    equal to the JAX legacy path's mod p (so to the JAX fused kernel's)."""
    plan = plans["plan"]
    assert int(plan.lens.min()) == 0 and int(plan.lens.max()) > 1
    got = fused.accumulate_buckets_fused(plans["gathered"], plan.starts, plan.lens)
    assert got.shape == (39, NWIN * H)
    assert torch.equal(got, plans["want"])


def test_fused_equals_port_legacy_and_stream(plans):
    """The port's three bucket-sum paths agree word for word."""
    plan = plans["plan"]
    rounds = buckets.round_class(int(plan.lens.max()))
    assert torch.equal(buckets.accumulate_buckets(plans["table"], plan, rounds),
                       plans["want"])
    layout = smvp_stream.build_stream_layout(plan.starts, plan.lens, NWIN)
    blocks = smvp_stream.accumulate_buckets_streamed(
        smvp_stream.build_signed_table(plans["table"]), plan.sorted_vals, layout)
    assert torch.equal(smvp_stream.permute_buckets(blocks, layout), plans["want"])


def test_windowed_matches_single_dispatch(plans):
    """Window by window over the first 12 windows (each runs its own
    longest bucket's rounds): the single dispatch's buckets."""
    plan, nw = plans["plan"], 12
    got = fused.accumulate_buckets_windowed(
        plans["rows"], plan.sorted_vals, plan.starts[:nw * H], plan.lens[:nw * H], nw)
    assert torch.equal(got, plans["want"][:, :nw * H])


def test_fused_wrapper_checks_its_operands(plans):
    plan = plans["plan"]
    with pytest.raises(ValueError, match="rows"):
        fused.accumulate_buckets_fused(plans["gathered"][:, :26].contiguous(),
                                       plan.starts, plan.lens)
    with pytest.raises(ValueError, match="one length"):
        fused.accumulate_buckets_fused(plans["gathered"], plan.starts, plan.lens[:4])
    with pytest.raises(ValueError, match="no kernel for device"):
        fused.accumulate_buckets_fused(plans["gathered"].to("meta"),
                                       plan.starts.to("meta"), plan.lens.to("meta"))


@pytest.mark.parametrize("nb,nw,n,total,windowed,single", [
    (512, 64, 96, 64 * 96, False, True),  # chunk 4: one dispatch
    (512, 64, 96, 31, False, False),
    (17 << 14, 17, 1 << 16, 17 << 16, True, True),  # chunk 15
    (17 << 14, 17, 31, 17 * 31, False, True),
    (51 << 4, 51, 96, 51 * 96, False, False),  # chunk 5: 816 buckets
])
def test_supported_predicates_match_jax(nb, nw, n, total, windowed, single):
    """Policy only: the JAX predicates' arithmetic (in interpret mode they
    need no TPU), without their backend test."""
    assert fused.windowed_supported(nb, nw, n) == windowed \
        == jfused.windowed_supported(nb, nw, n, True)
    assert fused.fused_supported(nb, total) == single \
        == jfused.fused_supported(nb, total, True)


# -- the fused engine ----------------------------------------------------------


def test_fused_engine_matches_oracle_and_jax_engine(case):
    """Forced "fused" == oracle == the JAX engine (which, off a TPU, sums
    the same buckets on its legacy path)."""
    got = engine(smvp_mode="fused").compute_msm(case["aff"], case["scalars"])
    assert (got["x"], got["y"]) == case["want"]
    jgot = jcuzk.CuzkMsmEngine(JCurveId.BLS12_377, chunk_size=CHUNK,
                               autotune=False).compute_msm(case["aff"], case["scalars"])
    assert got == jgot


def test_fused_engine_windowed_branch(case, monkeypatch):
    """chunk 9 fills whole 256-lane blocks per window: the engine takes
    accumulate_buckets_windowed; same MSM."""
    calls = []
    real = cuzk.accumulate_buckets_windowed
    monkeypatch.setattr(cuzk, "accumulate_buckets_windowed",
                        lambda *a: calls.append(1) or real(*a))
    n = 32
    got = engine(smvp_mode="fused", chunk_size=9).compute_msm(
        case["aff"][:n], case["scalars"][:n])
    assert calls == [1]
    assert (got["x"], got["y"]) == crv.g1_to_affine(
        naive_msm(case["pts"][:n], case["scalars"][:n], G1))


# -- the pure tree -------------------------------------------------------------


@pytest.mark.parametrize("heavy", [False, True], ids=["uniform", "duplicate-heavy"])
def test_pure_tree_engine_matches_oracle(case, heavy, monkeypatch):
    """smvp_mode="tree" without tree_finish: every level through
    run_tree_level, the last canonical, no packed finish."""
    scalars = HEAVY if heavy else case["scalars"]
    levels = []
    real = smvp_tree.run_tree_level
    monkeypatch.setattr(
        smvp_tree, "run_tree_level",
        lambda a, m, mode, last=False, sorted_vals=None:
        levels.append((mode, last)) or real(a, m, mode, last, sorted_vals))
    monkeypatch.setattr(smvp_tree, "packed_finish", None)
    got = engine(smvp_mode="tree").compute_msm(case["aff"], scalars)
    assert (got["x"], got["y"]) == crv.g1_to_affine(
        naive_msm(case["pts"], scalars, G1))
    assert levels[0][0] == "aff" and all(m == "full" for m, _ in levels[1:])
    assert [last for _, last in levels] == [False] * (len(levels) - 1) + [True]
    if heavy:  # one bucket holds all 96 entries of its window
        assert len(levels) == 7


def test_tree_bucket_sums_match_jax_legacy(plans):
    """tree_smvp + permute_tree give the buckets of the other paths as
    points (the tree adds in another order: other projective coordinates)."""
    plan = plans["plan"]
    kn = plan.sorted_vals.shape[0]
    tplan = smvp_tree.build_tree_plan(plan.starts, plan.lens, kn, NWIN)
    levels = smvp_tree.num_levels(int(tplan.max_len))
    final, s_fin = smvp_tree.tree_smvp(
        smvp_stream.build_signed_table(plans["table"]), plan.sorted_vals, tplan,
        levels)
    got = smvp_tree.permute_tree(
        final, smvp_tree.real_bucket_view(s_fin, NWIN),
        smvp_tree.real_bucket_view(tplan.lens, NWIN))

    def points(plane):
        cols = [F.plane_to_ints(F.from_mont(plane[c * 13:(c + 1) * 13]))
                for c in range(3)]
        return [crv.ProjectivePoint(*v) for v in zip(*cols)]

    assert all(crv.g1_eq(a, b) for a, b in zip(points(got), points(plans["want"])))


@pytest.mark.parametrize("max_len", [0, 1, 2, 3, 4, 5, 64, 65, 96, 1 << 17])
def test_num_levels_matches_jax(max_len):
    assert smvp_tree.num_levels(max_len) == jtree.num_levels(max_len)


@pytest.mark.parametrize("heavy", [False, True], ids=["uniform", "duplicate-heavy"])
def test_build_tree_plan_level_count_matches_jax(case, plans, heavy):
    """The plan's longest bucket (the level count's input) and its
    phantom-extended lens equal the JAX plan's."""
    if heavy:
        sw = ints_to_words(HEAVY, 8)
        jplan = jbuck.build_bucket_plan(
            jdec.decompose_scalars_signed(jnp.asarray(sw), CHUNK, NWIN), CHUNK)
        plan = buckets.build_bucket_plan(decompose.decompose_scalars_signed(
            torch.from_numpy(sw.view(np.int32)), CHUNK, NWIN), CHUNK)
    else:
        jplan, plan = plans["jplan"], plans["plan"]
    kn = plan.sorted_vals.shape[0]
    jt = jtree.build_tree_plan(jplan.starts, jplan.lens, kn, NWIN)
    tplan = smvp_tree.build_tree_plan(plan.starts, plan.lens, kn, NWIN)
    assert int(tplan.max_len) == int(np.asarray(jt.stats)[0])
    assert np.array_equal(tplan.lens.numpy(), np.asarray(jt.lens))
    levels = smvp_tree.num_levels(int(tplan.max_len))
    assert levels == jtree.num_levels(int(np.asarray(jt.stats)[0]))
    if heavy:  # one bucket holds all 96 entries of its window
        assert levels == 7


def test_permute_tree_matches_jax():
    """The same packed plane, offsets, lengths and BPR order through both
    permutes: equal as integers mod p, empty buckets the identity."""
    rng = random.Random("permute-tree")
    nb, t = NWIN * H, 700
    vals = [[rng.randrange(F.P) for _ in range(t)] for _ in range(3)]
    jfinal = jnp.concatenate([jnp.asarray(np.array(
        [[(v >> (13 * i)) & 0x1FFF for v in col] for i in range(W)],
        dtype=np.uint32)) for col in vals])
    final = torch.cat([F.ints_to_plane(col) for col in vals])
    lens = np.array([rng.choice([0, 1, 5]) for _ in range(nb)], dtype=np.int32)
    s_fin = np.array([rng.randrange(t) for _ in range(nb)], dtype=np.int32)
    order = bpr.bpr_order(NWIN, CHUNK, THREADS)
    for o in (None, order):
        want = jtree.permute_tree(JG1, jfinal, jnp.asarray(s_fin),
                                  jnp.asarray(lens), order=o)
        got = smvp_tree.permute_tree(final, torch.from_numpy(s_fin),
                                     torch.from_numpy(lens), order=o)
        want = from_jax_limbs(np.concatenate([np.asarray(c) for c in want]),
                              montgomery=False)
        # the identity's y is 1 in Montgomery form: R differs by package
        empty = torch.from_numpy(lens if o is None else lens[o.reshape(-1)]) == 0
        assert torch.equal(got[:, ~empty], want[:, ~empty])
        zero = smvp_tree.G1.zero(1)
        assert all(torch.equal(got[c * 13:(c + 1) * 13, empty],
                               zero[c].expand(13, int(empty.sum())))
                   for c in range(3))


def test_tree_k_semantics():
    """An explicit tree_finish wins; "auto" takes K = 2; an explicit "tree"
    alone is the pure tree, and the hybrid in a batch."""
    assert engine()._tree_k() == 2
    assert engine(smvp_mode="tree")._tree_k() is None
    assert engine(smvp_mode="tree")._tree_k(batch=True) == 2
    assert engine(smvp_mode="tree", tree_finish=3)._tree_k() == 3
    assert engine(tree_finish=1)._tree_k(batch=True) == 1
    with pytest.raises(ValueError, match="tree_finish"):
        engine(tree_finish=0)


# -- the path policy -----------------------------------------------------------


@pytest.mark.parametrize("chunk", range(4, 17))
def test_auto_policy_equals_jax_tpu_policy(chunk, monkeypatch):
    """For every n = 2^6..2^20 the port's "auto" path is the JAX engine's
    on a TPU with an empty autotune table: the JAX engine's own
    _select_smvp, with its backend probes answering as on a TPU."""
    for mod in (jstream, jtree, jfused):
        monkeypatch.setattr(mod, "_on_tpu", lambda: True)
    jeng = jcuzk.CuzkMsmEngine(JCurveId.BLS12_377, autotune=False)
    eng = CuzkMsmEngine(device="cpu")
    seen = set()
    for power in range(6, 21):
        n = 1 << power
        want = jeng._select_smvp(chunk, n)
        assert eng._select_smvp(chunk, n) == want, (chunk, power)
        seen.add(want)
    assert seen == ({"stream", "tree"} if chunk >= 9 else
                    {"fused"} if chunk in (4, 8) else {"legacy"})


def test_default_policy_takes_the_fused_path_below_2_16():
    eng = CuzkMsmEngine(device="cpu")
    for n in (1, 8, 1 << 10, 1 << 14, (1 << 16) - 1):
        assert eng._chunk_for(n) == 4 and eng._select_smvp(4, n) == "fused"


# -- batch mode ----------------------------------------------------------------


@pytest.fixture(scope="module")
def sets(case):
    rng = random.Random("batch-sets")
    return [case["scalars"]] + [[rng.randrange(0, 1 << 253) for _ in range(N)]
                                for _ in range(2)]


@contextlib.contextmanager
def no_host_reads(monkeypatch, plain_modules):
    """Inside the block every read of a tensor's values by the host (.cpu,
    .item, .tolist, .numpy, int(), bool(), float(), index) raises, except
    inside the kernels' plain forms, which stand in for launches here and
    read their loop bounds."""
    state = {"on": True}

    def guard(name):
        real = getattr(torch.Tensor, name)

        def fn(self, *a, **kw):
            if state["on"]:
                raise AssertionError(f"host read of a tensor: {name}")
            return real(self, *a, **kw)
        return fn

    def unguarded(real):
        def fn(*a, **kw):
            was, state["on"] = state["on"], False
            try:
                return real(*a, **kw)
            finally:
                state["on"] = was
        return fn

    with monkeypatch.context() as m:
        for name in ("cpu", "item", "tolist", "numpy", "__int__", "__bool__",
                     "__float__", "__index__"):
            m.setattr(torch.Tensor, name, guard(name))
        for mod in plain_modules:
            for name in dir(mod):
                if name.endswith("_plain"):
                    m.setattr(mod, name, unguarded(getattr(mod, name)))
        try:
            yield
        finally:
            state["on"] = False


@pytest.mark.parametrize("mode", ["tree", "stream"])
def test_batch_equals_per_set_msm_and_oracle(case, sets, mode, monkeypatch):
    """compute_msm_batch == compute_msm per set == oracle; the point table
    is built once for the batch; the per-set stage reads nothing back."""
    eng = engine(smvp_mode=mode)
    singles = [eng.compute_msm(case["aff"], s) for s in sets]
    assert (singles[0]["x"], singles[0]["y"]) == case["want"]
    for got, s in zip(singles[1:], sets[1:]):
        assert (got["x"], got["y"]) == crv.g1_to_affine(
            naive_msm(case["pts"], s, G1))

    built = {"mont_point_table": 0, "build_signed_table": 0}
    for name in built:
        real = getattr(cuzk, name)

        def counted(*a, _real=real, _name=name):
            built[_name] += 1
            return _real(*a)
        monkeypatch.setattr(cuzk, name, counted)
    real_sets = CuzkMsmEngine._batch_sets

    def guarded(self, *a):
        from webgpu_msm_bls12_377_tpu_torch.ops import kernels
        with no_host_reads(monkeypatch, (kernels, smvp_stream, smvp_tree)):
            return real_sets(self, *a)
    monkeypatch.setattr(CuzkMsmEngine, "_batch_sets", guarded)
    assert eng.compute_msm_batch(case["aff"], sets) == singles
    assert built == {"mont_point_table": 1, "build_signed_table": 1}


def test_the_host_read_guard_catches_a_readback(case, monkeypatch):
    """The guard of the test above does fire: the pure tree reads its level
    count back, so it cannot run inside it."""
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels
    eng = engine(smvp_mode="tree")
    with pytest.raises(AssertionError, match="host read"):
        with no_host_reads(monkeypatch, (kernels, smvp_stream, smvp_tree)):
            eng.compute_msm(case["aff"], case["scalars"])


def test_batch_on_other_paths_loops_compute_msm(case, sets):
    """Fused and legacy batches are a loop of compute_msm."""
    eng = engine()  # auto: chunk 4 -> fused
    assert eng._select_smvp(CHUNK, N) == "fused"
    n = 16
    got = eng.compute_msm_batch(case["aff"][:n], [s[:n] for s in sets[:2]])
    assert got == [eng.compute_msm(case["aff"][:n], s[:n]) for s in sets[:2]]


def test_batch_arguments(case, sets):
    eng = engine(smvp_mode="stream")
    with pytest.raises(NotImplementedError, match="item 16"):
        eng.compute_msm_batch(case["aff"], sets, devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="runs on cpu"):
        eng.compute_msm_batch(case["aff"], sets, devices=["cuda:0"])
    assert eng.compute_msm_batch(case["aff"], []) == []
    with pytest.raises(ValueError, match="mismatch"):
        eng.compute_msm_batch(case["aff"], [sets[0], sets[1][:5]])
    with pytest.raises(ValueError, match="2\\^253"):
        eng.compute_msm_batch(case["aff"], [[1 << 253] * N])
    n = 8
    one = eng.compute_msm_batch(case["aff"][:n], [sets[1][:n]], devices=["cpu"])
    assert one == [eng.compute_msm(case["aff"][:n], sets[1][:n])]


# -- the JAX fused kernel itself ------------------------------------------------


@pytest.mark.slow  # the manual-DMA kernel under the Pallas interpreter: ~17 min
def test_fused_buckets_match_jax_fused_kernel_interpret(plans):
    jrows = jfused.make_wide_rows(JG1, plans["jtable"])
    jgath = jfused.pregather_signed(JG1, jrows, plans["jplan"].sorted_vals)
    seg = jfused.segment_plan(plans["jplan"].starts, plans["jplan"].lens)
    out = jfused.accumulate_buckets_fused(JG1, jgath, seg, interpret=True)
    want = from_jax_limbs(np.concatenate([np.asarray(c) for c in out]),
                          montgomery=True)
    plan = plans["plan"]
    got = fused.accumulate_buckets_fused(plans["gathered"], plan.starts, plan.lens)
    assert torch.equal(got, want)
