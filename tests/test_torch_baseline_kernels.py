"""Kernels 6 and 7's one-launch forms against the JAX package, on the CPU
(plain PyTorch forms), both curves.

- scalar_mult (TPU row 12a, the naive engine's double-and-add in one
  launch): its plain form equals the JAX package's models/naive.py
  batched_scalar_mult (256 steps of masked_add_and_double, its jnp branch
  off a TPU) word for word, the scalar cut to its low `bits` bits for
  bits < 256; the wrapper equals the loop of masked_add_and_double_plain,
  and so does a model of the kernel's early stop (a lane stops after its
  top set bit).
- legacy_buckets (TPU row 11, every legacy round in one launch): its plain
  form over the signed table equals the JAX legacy accumulate_buckets at
  N = 96, chunk 4 (empty, length-1 and long buckets among them), on every
  bucket and on a window subset, word for word; the engine's pieces of at
  most PIECE entries, folded, give the same points.
- The legacy engine (PippengerMsmEngine) makes one bucket launch, one fold
  and one BPR a call and equals the JAX PippengerMsmEngine.
- tree_sum (TPU row 12b, the naive engine's tree sum in one launch): its
  plain form equals the JAX package's models/naive.py tree_sum (log2 N
  levels of fused_add, its jnp branch) word for word at widths 1, 2, 8
  and 16, with identity, equal and inverse partners; a model of the
  kernel's schedule (blocks over lane residues, a thread's own levels,
  shared-memory levels, the last block over the partials) equals it too.
- running_sum (TPU row 12c, the running-sum chain in one launch): its
  plain form over 1, 3 and 8 steps of a step-major walk equals as many
  chained calls of the JAX package's fused_running_add, word for word.

JAX values cross with from_jax_limbs (13-bit limbs, R = 2^390 or 2^260,
to 32-bit words, R = 2^416 or 2^288); canonical values have one
representation, so every comparison is exact.  Inputs from random.Random
and numpy seeds.
"""

import functools
import random
from dataclasses import astuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu.models import PippengerMsmEngine as JPippenger
from webgpu_msm_bls12_377_tpu.models import cuzk as jcuzk
from webgpu_msm_bls12_377_tpu.models import naive as jnaive
from webgpu_msm_bls12_377_tpu.ops import buckets as jbuck
from webgpu_msm_bls12_377_tpu.ops import curve as jcurve
from webgpu_msm_bls12_377_tpu.ops import decompose as jdec
from webgpu_msm_bls12_377_tpu.ops import pallas_kernels as jpk
from webgpu_msm_bls12_377_tpu.params import CurveId as JCurveId
from webgpu_msm_bls12_377_tpu_torch import params as PP
from webgpu_msm_bls12_377_tpu_torch.models import PippengerMsmEngine, cuzk
from webgpu_msm_bls12_377_tpu_torch.ops import buckets, decompose
from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK
from webgpu_msm_bls12_377_tpu_torch.ops.convert import (
    WireLayout,
    from_jax_limbs,
    ints_to_words,
)
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv

from test_torch_fused_pieces import same_points

# tiny tensors: one intra-op thread avoids oversubscribing the CPU
# beside the other test workers
torch.set_num_threads(1)

N = 96
CHUNK = 4
THREADS = 4
NWIN = decompose.num_windows_for(CHUNK)
H = 1 << (CHUNK - 1)
#: per curve: the port's group, the JAX group, JAX limbs a coordinate,
#: the JAX curve id, the subgroup order, the oracle's generator and
#: scalar multiplication, wire words a coordinate
SPEC = {
    "bls12_377": (C.G1, jcurve.G1Ops(), 30, JCurveId.BLS12_377,
                  PP.SCALAR_FIELD, crv.G1_GENERATOR, crv.g1_scalar_mult,
                  crv.g1_to_affine, 12),
    "edwards_bls12": (C.EDWARDS, jcurve.EdwardsOps(), 20,
                      JCurveId.EDWARDS_BLS12,
                      PP.EDWARDS_SUBGROUP_CHARACTERISTIC, crv.ED_GENERATOR,
                      crv.ed_scalar_mult, crv.ed_to_affine, 8),
}
CURVES = pytest.mark.parametrize("curve", list(SPEC), ids=["", "ed"])


def carry(pt, curve) -> torch.Tensor:
    """JAX canonical coordinates (a tuple of planes) -> the port's plane."""
    return from_jax_limbs(np.concatenate([np.asarray(c) for c in pt]),
                          montgomery=True, curve=CurveId(curve))


def scalar_words(ks) -> np.ndarray:
    return ints_to_words(ks, 8)


def point_words(curve, n, seed):
    """n points k * G (k < 2^60) as (2, k, n) wire words and their
    affine ints."""
    _, _, _, _, _, gen, mult, to_aff, cw = SPEC[curve]
    rng = random.Random(seed)
    aff = [to_aff(mult(gen, rng.randrange(1, 1 << 60))) for _ in range(n)]
    pw = np.stack([ints_to_words([a[0] for a in aff], cw),
                   ints_to_words([a[1] for a in aff], cw)])
    return pw, aff


def tables(curve, pw):
    """The port's Montgomery table (PLANE) and signed table (SIGNED), and
    the JAX package's Montgomery table, from the same wire words."""
    group, jgroup = SPEC[curve][:2]
    words = torch.from_numpy(pw.view(np.int32))
    layout = WireLayout.of(pw, False, group.ctx.nw - 1, 2)
    return (K.point_prep_plain(words, layout, group, K.PLANE),
            K.point_prep_plain(words, layout, group, K.SIGNED),
            jcuzk.mont_point_table(jgroup.ctx, jgroup, jnp.asarray(pw)))


# -- row 12a: scalar_mult ------------------------------------------------------


@CURVES
def test_scalar_mult_plain_matches_jax_batched_scalar_mult(curve):
    """k * P lane by lane: 0, 1, r - 1, 2^253 - 1 and 2^256 - 1 among the
    scalars; bits 256, 253 and 17 (the JAX function on k mod 2^bits)."""
    group, jgroup, order = SPEC[curve][0], SPEC[curve][1], SPEC[curve][4]
    n = 32
    pw, _ = point_words(curve, n, f"sm-{curve}")
    table, _, jtable = tables(curve, pw)
    rng = random.Random(f"sm-scalars-{curve}")
    ks = [0, 1, order - 1, (1 << 253) - 1, (1 << 256) - 1] + [
        rng.randrange(1 << 253) for _ in range(n - 5)]
    jfn = jax.jit(lambda t, s: jnaive.batched_scalar_mult(jgroup, t, s))
    sw = torch.from_numpy(scalar_words(ks).view(np.int32))
    for bits in (256, 253, 17):
        cut = [k % (1 << bits) for k in ks]
        want = carry(jfn(jtable, jnp.asarray(scalar_words(cut))), curve)
        got = K.scalar_mult_plain(table, sw, bits, group)
        assert got.shape == (group.rows, n)
        assert torch.equal(got, want), bits


def one_step_loop(table, sw, bits, group):
    """`bits` one-step launches' worth of masked_add_and_double_plain."""
    r = C.merge(group.zero(table.shape[1]))
    t = C.merge(group.from_affine(group.split_aff(table)))
    for i in range(bits):
        r, t = K.masked_add_and_double_plain(
            r, t, (sw[i // 32] >> (i % 32)) & 1, group)
    return r


def early_stop_model(table, sw, bits, group):
    """The kernel's schedule, lanes in lockstep: at step i < bitlen(k) a
    lane adds t where bit i is set and doubles t unless i is its top bit;
    past its top bit a lane does nothing (k cut to its low bits bits)."""
    ks = [sum((int(sw[w, j]) & 0xFFFFFFFF) << (32 * w) for w in range(8))
          % (1 << bits) for j in range(sw.shape[1])]
    top = torch.tensor([k.bit_length() for k in ks])
    r = group.zero(table.shape[1])
    t = group.from_affine(group.split_aff(table))
    for i in range(int(top.max()) if ks else 0):
        bit = torch.tensor([(k >> i) & 1 for k in ks]) == 1
        r = group.select(bit, group.add(r, t), r)
        t = group.select(i + 1 < top, group.double(t), t)
    return C.merge(r)


@CURVES
def test_scalar_mult_is_the_one_step_loop(curve):
    """The wrapper (its plain form here) against the loop of the one-step
    plain form, bit for bit, and the kernel's early stop against both:
    r no longer changes after a lane's top set bit."""
    group = SPEC[curve][0]
    n = 12
    pw, _ = point_words(curve, n, f"loop-{curve}")
    table = tables(curve, pw)[0]
    rng = np.random.default_rng(12)
    raw = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    raw[:, 0] = 0
    raw[:, 1] = [1, 0, 0, 0, 0, 0, 0, 0]
    raw[:, 2] = [0, 1 << 31, 0, 0, 0, 0, 0, 0]  # only bit 63 set
    raw[:, 3] = [0xFFFFFFFF] * 8
    sw = torch.from_numpy(raw.view(np.int32))
    for bits in (0, 1, 9, 64):
        want = one_step_loop(table, sw, bits, group)
        assert torch.equal(K.scalar_mult(table, sw, bits, group), want), bits
        assert torch.equal(early_stop_model(table, sw, bits, group), want), bits
    assert torch.equal(K.scalar_mult(table, sw, 0, group),
                       C.merge(group.zero(n)))


def test_scalar_mult_checks_its_operands():
    table = torch.zeros((26, 4), dtype=torch.int32)
    sw = torch.zeros((8, 4), dtype=torch.int32)
    for bits in (-1, 257):
        with pytest.raises(ValueError, match="bits"):
            K.scalar_mult(table, sw, bits)
    with pytest.raises(ValueError):
        K.scalar_mult(table, sw[:, :3])
    with pytest.raises(ValueError):
        K.scalar_mult(table[:25], sw)


# -- row 11: legacy_buckets ----------------------------------------------------


@pytest.fixture(scope="module", params=list(SPEC), ids=["", "ed"])
def legacy_case(request):
    """N = 96 points, chunk 4; 40 scalars equal (every window gets a
    bucket of at least 40 entries, longer than a piece), small scalars
    (the top windows' buckets are mostly empty).  The JAX legacy bucket
    sums and the port's signed table and plan from the same words."""
    curve = request.param
    group, jgroup, W = SPEC[curve][:3]
    pw, aff = point_words(curve, N, f"legacy-{curve}")
    rng = random.Random(f"legacy-scalars-{curve}")
    ks = [rng.randrange(1 << 253) for _ in range(N - 50)]
    ks += [rng.randrange(1 << 253)] * 40 + [rng.randrange(1 << 40)
                                            for _ in range(10)]
    sw = scalar_words(ks)
    _, signed, jtable = tables(curve, pw)
    jplan = jbuck.build_bucket_plan(
        jdec.decompose_scalars_signed(jnp.asarray(sw), CHUNK, NWIN), CHUNK)
    rounds = jbuck.round_class(int(np.asarray(jplan.lens).max()))
    jlegacy = jax.jit(lambda t, p: jbuck.accumulate_buckets(
        jgroup, jbuck.table_to_rows(t), p, rounds))(jtable, jplan)
    plan = buckets.build_bucket_plan(
        decompose.decompose_scalars_signed(torch.from_numpy(sw.view(np.int32)),
                                           CHUNK, NWIN), CHUNK)
    assert np.array_equal(plan.sorted_vals.numpy(),
                          np.asarray(jplan.sorted_vals))
    lens = plan.lens.tolist()
    assert 0 in lens and 1 in lens and max(lens) > SK.PIECE
    return dict(curve=curve, group=group, signed=signed, plan=plan,
                want=carry(jlegacy, curve), pw=pw, aff=aff, ks=ks)


@pytest.mark.parametrize("windows", [None, (1, 5, NWIN - 1)],
                         ids=["all", "subset"])
def test_legacy_buckets_plain_matches_jax_accumulate_buckets(legacy_case,
                                                             windows):
    """Every bucket (or a window subset's), one segment each: the JAX
    legacy sums word for word, empty buckets the identity."""
    s, plan = legacy_case, legacy_case["plan"]
    idx = (torch.arange(plan.starts.shape[0]) if windows is None else
           torch.as_tensor(buckets.window_slice_indices(windows, H)))
    got = buckets.legacy_buckets_plain(s["signed"], plan.sorted_vals,
                                       plan.starts[idx], plan.lens[idx],
                                       s["group"])
    assert got.shape == (s["group"].rows, idx.shape[0])
    assert torch.equal(got, s["want"][:, idx])
    # the wrapper takes the plain form for CPU tensors
    assert torch.equal(buckets.legacy_buckets(
        s["signed"], plan.sorted_vals, plan.starts[idx], plan.lens[idx],
        s["group"]), got)


def test_legacy_pieces_folded_are_the_same_points(legacy_case):
    """The engine's form: pieces of at most PIECE entries, each summed by
    legacy_buckets, folded by fold_pieces: a bucket of at most PIECE
    entries is the JAX sum word for word, a longer one the same point."""
    s, plan, group = legacy_case, legacy_case["plan"], legacy_case["group"]
    pp = SK.piece_plan(plan.starts, plan.lens, plan.sorted_vals.shape[0], N)
    assert int(pp.counts.max()) > 1
    sums = buckets.legacy_buckets(s["signed"], plan.sorted_vals, pp.starts,
                                  pp.lens, group)
    got, _ = SK.fold_pieces(sums, pp.counts, pp.offsets, pp.caps, group)
    short = plan.lens <= SK.PIECE
    assert torch.equal(got[:, short], s["want"][:, short])
    same_points(got, s["want"], group)


@pytest.fixture(scope="module")
def jax_pippenger(legacy_case):
    """The JAX PippengerMsmEngine on 16 of the points (its round classes,
    and so its compiles, stay few): (points, scalars, result)."""
    s = legacy_case
    aff, ks = s["aff"][:16], s["ks"][:16]
    return aff, ks, JPippenger(SPEC[s["curve"]][3],
                               chunk_size=CHUNK).compute_msm(aff, ks)


@pytest.mark.parametrize("piece", [None, 1], ids=["buckets", "pieces"])
def test_legacy_engine_makes_one_bucket_launch_and_one_bpr(
        legacy_case, jax_pippenger, piece, monkeypatch):
    """PippengerMsmEngine on the CPU: one legacy_buckets call over every
    window, one BPR, no per-window maxima and no window groups; with
    buckets longer than a piece on average (PIECE cut to 1 here, as chunk
    4 at 2^14 has them at 32), the call sums pieces and one fold adds
    them up.  The JAX PippengerMsmEngine's result."""
    aff, ks, want = jax_pippenger
    if piece is not None:
        monkeypatch.setattr(cuzk, "PIECE", piece)
    calls = []
    for name in ("legacy_buckets", "fold_pieces", "reduce_buckets_prearranged"):
        real = getattr(cuzk, name)
        monkeypatch.setattr(cuzk, name, lambda *a, _n=name, _f=real, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    got = PippengerMsmEngine(CurveId(legacy_case["curve"]), chunk_size=CHUNK,
                             num_bpr_threads=THREADS, device="cpu").compute_msm(
                                 aff, ks)
    want_calls = ["legacy_buckets", "reduce_buckets_prearranged"]
    if piece is not None:
        want_calls.append("fold_pieces")
    assert sorted(calls) == sorted(want_calls)
    assert got == want


# -- row 12b: tree_sum ---------------------------------------------------------


def oracle_ops(curve):
    """The oracle's point type, identity, negation and from_affine."""
    if curve == "bls12_377":
        return crv.ProjectivePoint, crv.G1_ZERO, crv.g1_neg, crv.g1_from_affine
    return crv.ExtendedPoint, crv.ED_ZERO, crv.ed_neg, crv.ed_from_affine


def both_points(curve, pts, rng):
    """Oracle points (G1 projective, Edwards extended), each at a random
    representative (every coordinate times one lam) -> the same points
    as canonical Montgomery planes of both packages: the port's merged
    (39|36, n) plane and the JAX group's Point of (w, n) limb planes."""
    group, jgroup, w = SPEC[curve][:3]
    p, nw = group.ctx.p, group.ctx.nw
    cols = [[] for _ in astuple(pts[0])]
    for pt in pts:
        lam = rng.randrange(1, p)
        for col, c in zip(cols, astuple(pt)):
            col.append(c * lam % p)
    port = torch.cat([F.ints_to_plane([v * (1 << 32 * nw) % p for v in col],
                                      nw=nw) for col in cols])
    jax_pt = jgroup.Point(*(jnp.asarray(np.array(
        [[(v * (1 << 13 * w) % p >> (13 * i)) & 0x1FFF for v in col]
         for i in range(w)], dtype=np.uint32)) for col in cols))
    assert torch.equal(carry(jax_pt, curve), port)
    return port, jax_pt


def random_points(curve, n, rng):
    _, _, _, _, _, gen, mult, to_aff, _ = SPEC[curve]
    from_aff = oracle_ops(curve)[3]
    return [from_aff(*to_aff(mult(gen, rng.randrange(1, 1 << 60))))
            for _ in range(n)]


def tree_points(curve, width, kind, rng):
    """width oracle points for the tree: "edges": the first level meets
    the identity (lane half), an equal partner (half + 1: a doubling
    through the add) and an inverse one (half + 2: the identity out);
    "double": the halves are equal (every first-level add a doubling, the
    identity at lane 0 among them); "inverse": the second half negates
    the first (the first level all identities, added up after)."""
    _, zero, neg, _ = oracle_ops(curve)
    half = width // 2
    pts = random_points(curve, width, rng)
    if kind == "edges":
        for off, make in ((0, lambda q: zero), (1, lambda q: q), (2, neg)):
            if off < half:
                pts[half + off] = make(pts[off])
    elif kind == "double":
        pts[0] = zero
        pts[half:] = pts[:half]
    else:
        pts[half:] = [neg(q) for q in pts[:half]]
    return pts


TREE_CASES = [(1, "edges")] + [(w, k) for w in (2, 8, 16)
                               for k in ("edges", "double", "inverse")]
#: lanes of the jitted JAX adds: every level of a width-16 tree fits
JAX_LANES = 8


@functools.lru_cache(maxsize=None)
def jax_kernel(curve, name):
    """The JAX package's lane-wise fused_add or fused_running_add (its jnp
    branch off a TPU), jitted: one compile a curve."""
    jgroup, fn = SPEC[curve][1], getattr(jpk, name)
    return jax.jit(lambda *pts: fn(jgroup, *pts))


def jax_fused_add_padded(curve):
    """fused_add(group, a, b) for the JAX tree_sum's levels: the operands
    padded with their first lane to JAX_LANES lanes (the add is lane-wise),
    added by jax_kernel's one compile, cut back."""
    add = jax_kernel(curve, "fused_add")

    def run(group, a, b):
        n = a[0].shape[-1]

        def pad(pt):
            return type(pt)(*(jnp.concatenate(
                [c] + [c[:, :1]] * (JAX_LANES - n), axis=1) for c in pt))
        return type(a)(*(c[:, :n] for c in add(pad(a), pad(b))))
    return run


@CURVES
@pytest.mark.parametrize("width,kind", TREE_CASES,
                         ids=[f"{w}-{k}" for w, k in TREE_CASES])
def test_tree_sum_plain_matches_jax_tree_sum(curve, width, kind, monkeypatch):
    """The port's tree_sum (its plain form here) against the JAX package's
    models/naive.py:tree_sum, word for word: the same pairs (lane i +
    lane i + half) at every level.  The JAX tree runs as written, its
    levels' lane-wise fused_add on padded lanes (one compile a curve)."""
    group, jgroup = SPEC[curve][:2]
    rng = random.Random(f"tree-{curve}-{width}-{kind}")
    port, jpts = both_points(curve, tree_points(curve, width, kind, rng), rng)
    monkeypatch.setattr(jnaive, "fused_add", jax_fused_add_padded(curve))
    want = carry(jnaive.tree_sum(jgroup, jpts), curve)
    got = K.tree_sum(port, group)
    assert got.shape == (group.rows, 1)
    assert torch.equal(got, want)
    assert torch.equal(K.tree_sum_plain(port, group), want)


def brev(s: int, bits: int) -> int:
    """The low `bits` bits of s reversed (__brev(s) >> (32 - bits))."""
    return int(f"{s:0{bits}b}"[::-1], 2) if bits else 0


def tree_sum_kernel_model(points, group, threads):
    """csrc/canon.cu's tree_sum_kernel schedule, `threads` threads a block:
    G = N / (2 threads) blocks (at least 1, at most 2 threads), block b
    the lanes b + G k; block_fold (a thread's elements t + threads r
    folded on its own depth first, in bit-reversed order of the first
    level's pairs, then a level a step over the threads), then the last
    block's block_fold over the G partials; each add a one-lane
    fused_add_plain."""
    n = points.shape[1]
    blocks = min(max(n // (2 * threads), 1), 2 * threads)

    def add(x, y):
        return K.fused_add_plain(x, y, group)

    def thread_fold(col, base, stride, per):
        pairs = per // 2
        bits = pairs.bit_length() - 1
        stack = []
        for s in range(pairs):
            r = brev(s, bits)
            stack.append(add(col(base + stride * r),
                             col(base + stride * (r + pairs))))
            c = s + 1
            while c % 2 == 0:
                top = stack.pop()
                stack[-1] = add(stack[-1], top)
                c //= 2
        assert len(stack) == 1
        return stack[0]

    def block_fold(col, base, stride, count):
        width = min(count, threads)
        sm = [thread_fold(col, base + stride * t, stride * threads,
                          count // threads) if count > threads
              else col(base + stride * t) for t in range(width)]
        off = width // 2
        while off >= 1:
            for t in range(off):
                sm[t] = add(sm[t], sm[t + off])
            off //= 2
        return sm[0]

    def lanes(plane):
        return lambda j: plane[:, j:j + 1]

    parts = [block_fold(lanes(points), b, blocks, n // blocks)
             for b in range(blocks)]
    if blocks == 1:
        return parts[0]
    return block_fold(lanes(torch.cat(parts, dim=1)), 0, 1, blocks)


@CURVES
@pytest.mark.parametrize("threads", [2, 4])
def test_tree_sum_kernel_schedule_is_the_tree(curve, threads):
    """The kernel's schedule, at 2 and 4 threads a block (so that small
    widths take one block, several, and a thread's own levels over up to
    16 elements), against the plain tree word for word: the same pairs,
    only in another order of evaluation."""
    group = SPEC[curve][0]
    ctx = group.ctx
    rng = random.Random(f"tree-model-{curve}-{threads}")
    for width in (1, 2, 4, 8, 16, 32, 64, 128):
        plane = F.ints_to_plane([rng.randrange(ctx.p) for _ in range(
            width * group.rows // ctx.nw)], nw=ctx.nw)
        plane = plane.reshape(ctx.nw, group.rows // ctx.nw, width)
        plane = plane.transpose(0, 1).reshape(group.rows, width)
        assert torch.equal(tree_sum_kernel_model(plane, group, threads),
                           K.tree_sum_plain(plane, group)), width


# -- row 12c: running_sum ------------------------------------------------------


@CURVES
@pytest.mark.parametrize("steps", [1, 3, 8])
def test_running_sum_plain_matches_chained_jax_fused_running_add(curve, steps):
    """running_sum over a step-major walk against `steps` chained calls of
    the JAX package's fused_running_add (its jnp branch), word for word;
    m starts at the identity in lane 0 and g in lane 1, and step 0's
    addends are equal to m (lane 2) and its inverse (lane 3)."""
    group, jgroup = SPEC[curve][:2]
    _, zero, neg, _ = oracle_ops(curve)
    n = 8
    rng = random.Random(f"running-{curve}-{steps}")
    m0, g0 = random_points(curve, n, rng), random_points(curve, n, rng)
    m0[0], g0[1] = zero, zero
    walk = random_points(curve, steps * n, rng)
    walk[2], walk[3] = m0[2], neg(m0[3])
    pm, jm = both_points(curve, m0, rng)
    pg, jg = both_points(curve, g0, rng)
    pw, jw = both_points(curve, walk, rng)
    step = jax_kernel(curve, "fused_running_add")
    for t in range(steps):
        jm, jg = step(jm, jg, jgroup.Point(*(c[:, t * n:(t + 1) * n]
                                             for c in jw)))
    want = carry(jm, curve), carry(jg, curve)
    got = K.running_sum_plain(pm, pg, pw, steps, group)
    for g_, w_ in zip(got, want):
        assert g_.shape == (group.rows, n)
        assert torch.equal(g_, w_)
    # the wrapper takes the plain form for CPU tensors; one step is the
    # one-step counterpart of the JAX function
    for g_, w_ in zip(K.running_sum(pm, pg, pw, steps, group), want):
        assert torch.equal(g_, w_)
    assert all(torch.equal(a, b) for a, b in zip(
        K.fused_running_add(pm, pg, pw[:, :n], group),
        K.fused_running_add_plain(pm, pg, pw[:, :n], group)))


@CURVES
def test_tree_sum_and_running_sum_check_their_operands(curve):
    group = SPEC[curve][0]
    rows = group.rows
    plane = C.merge(group.zero(8))
    for width in (0, 3, 6, 12):
        with pytest.raises(ValueError, match="power-of-two"):
            K.tree_sum(torch.zeros((rows, width), dtype=torch.int32), group)
    with pytest.raises(ValueError):
        K.tree_sum(plane[:rows - 1], group)
    walk = torch.cat([plane] * 3, dim=1)
    assert all(torch.equal(x, plane) for x in
               K.running_sum(plane, plane, walk, 3, group))
    for steps in (0, -1):
        with pytest.raises(ValueError, match="steps"):
            K.running_sum(plane, plane, walk, steps, group)
    with pytest.raises(ValueError):
        K.running_sum(plane, plane, walk, 2, group)  # 24 columns, not 16
    with pytest.raises(ValueError):
        K.running_sum(plane, plane[:, :4], walk, 3, group)
    with pytest.raises(ValueError):
        K.running_sum(plane[:rows - 1], plane[:rows - 1], walk[:rows - 1], 3,
                      group)
    # one level of the tree has no kernel: CPU only
    assert torch.equal(K.fused_add(plane, plane, group), plane)
