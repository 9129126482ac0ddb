"""Port Twisted Edwards BLS12 in the canonical domain against the JAX
package and the bigint oracle: the canonical hwcd forms, the fused SMVP
(wide rows, pre-gathered rows, bucket sums), the legacy round, the
canonical kernel family, and the paths and engines that run them (fused,
legacy and "auto" at chunk 4, PippengerMsmEngine, NaiveMsmEngine, batches).
CPU, plain PyTorch versions of kernels 6, 7 and 8.

The port's Edwards values are 9 x 32-bit words (R = 2^288), the JAX
package's 20 x 13-bit limbs (R = 2^260): JAX state crosses with
from_jax_limbs / from_jax_rows (x*2^260 -> x*2^288, reduced mod p).  Both
packages reduce after every field operation in this domain, so canonical
outputs must be equal integers.  The JAX forms are its jnp EdwardsOps and
the jnp branches of its ops/pallas_kernels.py (interpret off, as its own
CPU tests run them); bucket sums are held against the JAX legacy
accumulate_buckets (its test suite holds the fused kernel bit-identical to
that path; the fused kernel under the Pallas interpreter is a slow test).
Shapes: N = 96 points, chunk 4 (64 windows of 8 buckets), inputs from
random.Random seeds.  Every comparison is exact equality: no tolerance.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu.models import PippengerMsmEngine as JPippenger
from webgpu_msm_bls12_377_tpu.models import cuzk as jcuzk
from webgpu_msm_bls12_377_tpu.ops import buckets as jbuck
from webgpu_msm_bls12_377_tpu.ops import curve as jcurve
from webgpu_msm_bls12_377_tpu.ops import decompose as jdec
from webgpu_msm_bls12_377_tpu.ops import pallas_kernels as jpk
from webgpu_msm_bls12_377_tpu.ops import smvp_kernel as jfused
from webgpu_msm_bls12_377_tpu.params import CurveId as JCurveId
from webgpu_msm_bls12_377_tpu_torch.models import (
    CuzkMsmEngine,
    NaiveMsmEngine,
    PippengerMsmEngine,
)
from webgpu_msm_bls12_377_tpu_torch.models.naive import tree_sum
from webgpu_msm_bls12_377_tpu_torch.ops import buckets, decompose
from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as fused
from webgpu_msm_bls12_377_tpu_torch.ops.convert import (
    from_jax_limbs,
    from_jax_rows,
    ints_to_words,
)
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import EDWARDS, naive_msm

from test_torch_fused_pieces import same_points

# tiny tensors: one intra-op thread avoids oversubscribing the CPU
# beside the other test workers
torch.set_num_threads(1)

ED_ID = CurveId.EDWARDS_BLS12
ED = C.EDWARDS
JED = jcurve.EdwardsOps()
P = ED.ctx.p
NWD = ED.ctx.nw  # 9 words
R = 1 << 288
RJ = 1 << 260
W = 20  # JAX limbs per Edwards field element
N = 96
CHUNK = 4
THREADS = 4
NWIN = decompose.num_windows_for(CHUNK)
H = 1 << (CHUNK - 1)


def plane(vals) -> torch.Tensor:
    return F.ints_to_plane(vals, nw=NWD)


def jax_plane(vals) -> jnp.ndarray:
    """ints < 2^260 -> (20, n) canonical 13-bit JAX limbs."""
    return jnp.asarray(np.array(
        [[(v >> (13 * i)) & 0x1FFF for v in vals] for i in range(W)],
        dtype=np.uint32))


def carry(pt) -> torch.Tensor:
    """JAX Edwards coordinates (a tuple of planes, or a merged (k*20, n)
    plane) -> the port's canonical (k*9, n) plane."""
    arr = np.concatenate([np.asarray(c) for c in pt]) if isinstance(
        pt, tuple) else np.asarray(pt)
    return from_jax_limbs(arr, montgomery=True, curve=ED_ID)


def rand_point(rng):
    return crv.ed_scalar_mult(crv.ED_GENERATOR, rng.randrange(1, 1 << 60))


def projective(rng, pt):
    """A random representative (lam x : lam y : lam t : lam z)."""
    lam = rng.randrange(1, P)
    return crv.ExtendedPoint(*(c * lam % P for c in (pt.x, pt.y, pt.t, pt.z)))


def both(pts):
    """The same extended points as Montgomery planes of both packages."""
    cols = [[getattr(p, c) for p in pts] for c in "xytz"]
    return (C.ExtEd(*(plane([v * R % P for v in col]) for col in cols)),
            jcurve.ExtEd(*(jax_plane([v * RJ % P for v in col]) for col in cols)))


def both_affine(pts):
    """Affine (x, y, t = xy) Montgomery planes of both packages."""
    aff = [crv.ed_to_affine(p) for p in pts]
    vals = [[x, y, x * y % P] for x, y in aff]
    return (tuple(plane([v[c] * R % P for v in vals]) for c in range(3)),
            tuple(jax_plane([v[c] * RJ % P for v in vals]) for c in range(3)))


def as_oracle(pt) -> list:
    rinv = pow(R, -1, P)
    cols = [[v * rinv % P for v in F.plane_to_ints(c)] for c in pt]
    return [crv.ExtendedPoint(*v) for v in zip(*cols)]


def edge_lanes(rng):
    """(first, second) operand lists: generic lanes, then equal (a
    doubling through the add), inverse, and the identity on either side
    and on both, each at a random projective representative."""
    a = [rand_point(rng) for _ in range(5)]
    b = [rand_point(rng) for _ in range(5)]
    a += [a[0], a[1], crv.ED_ZERO, a[2], crv.ED_ZERO]
    b += [a[0], crv.ed_neg(a[1]), a[3], crv.ED_ZERO, crv.ED_ZERO]
    return [projective(rng, p) for p in a], [projective(rng, p) for p in b]


# -- the canonical hwcd forms -------------------------------------------------


@pytest.mark.parametrize("form", ["add", "add_mixed", "double"])
def test_canonical_forms_match_jax_and_oracle(form):
    """Each canonical form on canonical inputs with identity, equal and
    inverse lanes: outputs below p, equal to the JAX form's as integers
    and to the oracle's as points."""
    rng = random.Random(f"ed-canon-{form}")
    a, b = edge_lanes(rng)
    pa, ja = both(a)
    if form == "add":
        pb, jb = both(b)
        got, want = ED.add(pa, pb), jax.jit(JED.add)(ja, jb)
        oracle = [crv.ed_add(x, y) for x, y in zip(a, b)]
    elif form == "add_mixed":
        b = [crv.ed_from_affine(*crv.ed_to_affine(p)) for p in b]
        pb, jb = both_affine(b)
        got, want = ED.add_mixed(pa, pb), jax.jit(JED.add_mixed)(ja, jb)
        oracle = [crv.ed_add(x, y) for x, y in zip(a, b)]
    else:
        got, want = ED.double(pa), jax.jit(JED.double)(ja)
        oracle = [crv.ed_double(x) for x in a]
    assert all(v < P for c in got for v in F.plane_to_ints(c))
    assert torch.equal(C.merge(got), carry(tuple(want)))
    assert all(crv.ed_eq(x, y) for x, y in zip(as_oracle(got), oracle))


def test_canonical_neg_and_is_zero_match_jax():
    """neg (x and t negated, 0 -> 0) and is_zero (x == 0 and y == z, at
    any representative of the identity) equal the JAX forms."""
    rng = random.Random("ed-canon-neg")
    a, _ = edge_lanes(rng)
    pa, ja = both(a)
    assert torch.equal(C.merge(ED.neg(pa)), carry(tuple(JED.neg(ja))))
    assert all(crv.ed_eq(x, crv.ed_neg(y))
               for x, y in zip(as_oracle(ED.neg(pa)), a))
    want = [p.x == 0 and p.y == p.z for p in a]
    assert ED.is_zero(pa).tolist() == want == \
        np.asarray(JED.is_zero(ja)).reshape(-1).tolist()
    assert want.count(True) == 2


# -- the fused and legacy bucket sums -----------------------------------------


@pytest.fixture(scope="module")
def case():
    rng = random.Random("ed-canon-engine")
    pts = [rand_point(rng) for _ in range(N)]
    scalars = [rng.randrange(0, 1 << 253) for _ in range(N)]
    scalars[0], scalars[1], scalars[2] = 0, 1, (1 << 253) - 1
    aff = [crv.ed_to_affine(p) for p in pts]
    pw = np.stack([ints_to_words([a[0] for a in aff], 8),
                   ints_to_words([a[1] for a in aff], 8)])
    return dict(pts=pts, aff=aff, scalars=scalars, pw=pw,
                sw=ints_to_words(scalars, 8),
                want=crv.ed_to_affine(naive_msm(pts, scalars, EDWARDS)))


@pytest.fixture(scope="module")
def plans(case):
    """The JAX table, plan and legacy bucket sums, and the port's table,
    plan, wide rows and pre-gathered rows from the same words."""
    jtable = jcuzk.mont_point_table(JED.ctx, JED, jnp.asarray(case["pw"]))
    jplan = jbuck.build_bucket_plan(
        jdec.decompose_scalars_signed(jnp.asarray(case["sw"]), CHUNK, NWIN),
        CHUNK)
    rounds = jbuck.round_class(int(np.asarray(jplan.lens).max()))
    legacy = jax.jit(lambda t, p: jbuck.accumulate_buckets(
        JED, jbuck.table_to_rows(t), p, rounds))(jtable, jplan)
    table = carry(np.asarray(jtable).reshape(3 * W, N))
    plan = buckets.build_bucket_plan(
        decompose.decompose_scalars_signed(
            torch.from_numpy(case["sw"].view(np.int32)), CHUNK, NWIN), CHUNK)
    assert np.array_equal(plan.sorted_vals.numpy(), np.asarray(jplan.sorted_vals))
    rows = fused.make_wide_rows(table, ED)
    return dict(jtable=jtable, jplan=jplan, table=table, plan=plan,
                rounds=rounds, want=carry(tuple(legacy)), rows=rows,
                gathered=fused.pregather_signed(rows, plan.sorted_vals, ED))


def test_make_wide_rows_and_pregather_match_jax(plans):
    """Rows [x, y, t, -x, -t]; pre-gathered rows [x|-x, y, t|-t] by the
    entry's sign (a negative digit negates x and t, not y), five zero
    words after them."""
    jrows = jfused.make_wide_rows(JED, plans["jtable"])
    assert plans["rows"].shape == (N, 45)
    assert torch.equal(plans["rows"],
                       from_jax_rows(jrows, 5, montgomery=True, curve=ED_ID))
    jgath = np.asarray(jfused.pregather_signed(JED, jrows,
                                               plans["jplan"].sorted_vals))
    count = plans["plan"].sorted_vals.shape[0]
    got = plans["gathered"]
    assert got.shape == (count, fused.ROW_WORDS) and got.dtype == torch.int32
    assert torch.equal(got[:, :27], from_jax_rows(jgath[:count], 3,
                                                  montgomery=True, curve=ED_ID))
    assert not got[:, 27:].any()
    # both signs occur, and the sign moves x and t only
    sign = (plans["plan"].sorted_vals >> buckets.SIGN_BIT) & 1
    assert 0 < int(sign.sum()) < count
    rows = plans["rows"][plans["plan"].sorted_vals & buckets.IDX_MASK]
    neg = sign == 0
    assert torch.equal(got[neg, :9], rows[neg, 27:36])
    assert torch.equal(got[neg, 9:18], rows[neg, 9:18])
    assert torch.equal(got[neg, 18:27], rows[neg, 36:45])


def test_fused_buckets_match_jax_legacy(plans):
    """The plain forms of the fused path on the whole plan, in one pass and
    window by window, with pieces as long as the longest bucket (the fold
    adds nothing): the JAX legacy path's canonical coordinates."""
    plan = plans["plan"]
    longest = int(plan.lens.max())
    assert int(plan.lens.min()) == 0 and longest > 1
    got = fused.accumulate_buckets_fused(plans["gathered"], plan.starts,
                                         plan.lens, ED, piece=longest)
    assert got.shape == (36, NWIN * H)
    assert torch.equal(got, plans["want"])
    nw = 12
    got = fused.accumulate_buckets_windowed(
        plans["rows"], plan.sorted_vals, plan.starts[:nw * H],
        plan.lens[:nw * H], nw, ED, piece=longest)
    assert torch.equal(got, plans["want"][:, :nw * H])


@pytest.mark.parametrize("piece", [2, 4])
def test_pieces_shorter_than_buckets_give_the_same_points(plans, piece):
    """Pieces of 2 or 4 rows, in one pass and window by window: buckets no
    longer than a piece keep the JAX legacy sums word for word; every
    bucket is the same point in other coordinates."""
    plan = plans["plan"]
    short = plan.lens <= piece
    assert short.any() and (~short).any()
    got = fused.accumulate_buckets_fused(plans["gathered"], plan.starts,
                                         plan.lens, ED, piece=piece, max_len=N)
    assert torch.equal(got[:, short], plans["want"][:, short])
    same_points(got, plans["want"], ED)
    nw = 12
    win = fused.accumulate_buckets_windowed(
        plans["rows"], plan.sorted_vals, plan.starts[:nw * H],
        plan.lens[:nw * H], nw, ED, piece=piece)
    assert torch.equal(win, got[:, :nw * H])


def test_legacy_accumulate_buckets_matches_jax(plans):
    """Lockstep rounds of kernel 6's plain form over the (27, N) table: the
    JAX legacy sums, word for word; a window group is a slice of them."""
    plan = plans["plan"]
    assert buckets.round_class(int(plan.lens.max())) == plans["rounds"]
    got = buckets.accumulate_buckets(plans["table"], plan, plans["rounds"], ED)
    assert got.shape == (36, NWIN * H)
    assert torch.equal(got, plans["want"])
    idx = torch.as_tensor(buckets.window_slice_indices((1, 5, NWIN - 1), H))
    plan_g = buckets.BucketPlan(plan.sorted_vals, plan.starts[idx],
                                plan.lens[idx])
    got = buckets.accumulate_buckets(
        plans["table"], plan_g, buckets.round_class(int(plan_g.lens.max())), ED)
    assert torch.equal(got, plans["want"][:, idx])


# -- the canonical kernel family ----------------------------------------------


@pytest.mark.parametrize("kernel", ["masked_add_mixed", "fused_add",
                                    "masked_add_and_double",
                                    "fused_running_add"])
def test_canonical_kernels_match_jax(kernel):
    """Each plain form against the JAX package's entry point of the same
    name (its jnp branch off a TPU), on edge lanes; masks and signs mixed."""
    rng = random.Random(f"ed-k7-{kernel}")
    a, b = edge_lanes(rng)
    n = len(a)
    pa, ja = both(a)
    pb, jb = both(b)
    pg, jg = both([projective(rng, rand_point(rng)) for _ in range(n)])
    flags = [rng.randrange(2) for _ in range(2 * n)]
    f1 = torch.tensor(flags[:n], dtype=torch.int32)
    f2 = torch.tensor(flags[n:], dtype=torch.int32)
    j1, j2 = jnp.asarray(np.array(flags[:n]) == 1), jnp.asarray(np.array(flags[n:]) == 1)
    ma, mb, mg = C.merge(pa), C.merge(pb), C.merge(pg)
    if kernel == "masked_add_mixed":
        paff, jaff = both_affine(b)
        got = K.masked_add_mixed_plain(ma, C.merge(paff), f1, f2, ED)
        want = jpk.masked_add_mixed(JED, ja, jaff, j1, j2)
    elif kernel == "fused_add":
        got, want = K.fused_add(ma, mb, ED), jpk.fused_add(JED, ja, jb)
    elif kernel == "masked_add_and_double":
        got = K.masked_add_and_double_plain(ma, mb, f1, ED)
        want = jpk.masked_add_and_double(JED, ja, jb, j1)
    else:
        got = K.fused_running_add(ma, mg, mb, ED)
        want = jpk.fused_running_add(JED, ja, jg, jb)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want[0], jcurve.ExtEd) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, carry(tuple(w)))


# -- the engines --------------------------------------------------------------


def engine(cls=CuzkMsmEngine, **kw):
    opts = dict(chunk_size=CHUNK, num_bpr_threads=THREADS, device="cpu")
    opts.update(kw)
    return cls(ED_ID, **opts)


@pytest.fixture(scope="module")
def jax_result(case):
    """The JAX engine's Edwards MSM at chunk 4 (off a TPU its legacy
    path), which must be the oracle's and the JAX PippengerMsmEngine's
    (tests/test_engine.py's chunk)."""
    got = jcuzk.CuzkMsmEngine(JCurveId.EDWARDS_BLS12, chunk_size=CHUNK,
                              autotune=False).compute_msm(case["aff"],
                                                          case["scalars"])
    assert (got["x"], got["y"]) == case["want"]
    assert JPippenger(JCurveId.EDWARDS_BLS12, chunk_size=CHUNK).compute_msm(
        case["aff"], case["scalars"]) == got
    return got


@pytest.mark.parametrize("mode", ["fused", "legacy", "auto"])
def test_edwards_engine_paths_match_jax_and_oracle(case, jax_result, mode):
    """Chunk 4: "auto" takes the fused path, as the JAX engine's policy
    does on a TPU."""
    eng = engine(smvp_mode=mode)
    assert eng._select_smvp(CHUNK, N) == ("fused" if mode == "auto" else mode)
    assert eng.compute_msm(case["aff"], case["scalars"]) == jax_result


def test_pippenger_engine_matches_jax_pippenger_and_oracle(case, jax_result):
    eng = engine(PippengerMsmEngine)
    assert eng.smvp_mode == "legacy"
    assert eng.compute_msm(case["aff"], case["scalars"]) == jax_result
    with pytest.raises(ValueError, match="legacy"):
        PippengerMsmEngine(ED_ID, smvp_mode="fused", device="cpu")


def test_naive_engine_matches_oracle(case):
    """Double-and-add and the tree sum on (36, L) planes: the (36, 1)
    extended sum in plain form is the oracle's point."""
    n = 8
    out = NaiveMsmEngine(ED_ID, device="cpu").build_fn()(case["pw"][:, :, :n],
                                                        case["sw"][:, :n])
    assert out.shape == (36, 1)
    got = crv.ExtendedPoint(*(F.plane_to_ints(out[c * NWD:(c + 1) * NWD])[0]
                              for c in range(4)))
    assert crv.ed_to_affine(got) == crv.ed_to_affine(
        naive_msm(case["pts"][:n], case["scalars"][:n], EDWARDS))
    with pytest.raises(ValueError, match="power-of-two"):
        tree_sum(torch.zeros((36, 6), dtype=torch.int32), ED)


@pytest.mark.parametrize("mode", ["fused", "legacy"])
def test_edwards_batch_on_fused_and_legacy_loops_compute_msm(case, mode):
    rng = random.Random(f"ed-canon-batch-{mode}")
    n = 16
    sets = [case["scalars"][:n], [rng.randrange(0, 1 << 253) for _ in range(n)]]
    eng = engine(smvp_mode=mode)
    got = eng.compute_msm_batch(case["aff"][:n], sets)
    for g, s in zip(got, sets):
        assert (g["x"], g["y"]) == crv.ed_to_affine(
            naive_msm(case["pts"][:n], s, EDWARDS))
