"""Port field layer (webgpu_msm_bls12_377_tpu_torch/ops/field.py) against
exact bigint arithmetic and the JAX package's ops/field.py.

The port's values are exact integers below 2^416 (BLS12-377: 13 x 32-bit
words, R = 2^416) or 2^288 (Twisted Edwards BLS12: 9 words, R = 2^288), so
its Montgomery products are checked for exact equality with REDC(T) =
(T + m p) / R, and its lazy add/sub/neg for exact equality with the integer
expressions.  Against JAX (30 or 20 x 13-bit limbs, R = 2^390 or 2^260) the
comparison is mod p at canonical boundaries, through from_jax_limbs.  The
tests that hold for both fields run for each (ids ``[...]`` for BLS12-377,
``[ed...]`` for Edwards).  Every comparison is exact integer equality: no
tolerance applies.
"""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu import params as JP
from webgpu_msm_bls12_377_tpu.ops import field as JF
from webgpu_msm_bls12_377_tpu.params import CurveId as JCurveId
from webgpu_msm_bls12_377_tpu_torch import params as PP
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops.convert import from_jax_limbs

# tiny tensors: one intra-op thread avoids oversubscribing the CPU
# beside the other test workers
torch.set_num_threads(1)

P = F.P
R = 1 << 416
RJ = 1 << 390
JCTX = JF.field_ctx(JCurveId.BLS12_377)
N = 48


class Field:
    """One field as the tests that hold for both need it: the port's
    context, its R, the JAX context, limbs and R, and the largest bound
    product the point formulas feed one Montgomery product (REDC output
    below 2p up to it)."""

    def __init__(self, curve, ctx, jctx, w, jax_p, max_bound):
        self.curve, self.ctx, self.jctx, self.w = curve, ctx, jctx, w
        self.jax_p = jax_p
        self.p, self.nw = ctx.p, ctx.nw
        self.r_full, self.rj = 1 << (32 * ctx.nw), 1 << (13 * w)
        self.max_bound = max_bound

    def plane(self, vals) -> torch.Tensor:
        return F.ints_to_plane(vals, nw=self.nw)

    def jax_limbs(self, vals) -> jnp.ndarray:
        return jnp.asarray(np.array(
            [[(v >> (13 * i)) & 0x1FFF for v in vals] for i in range(self.w)],
            dtype=np.uint32))

    def carry(self, arr) -> torch.Tensor:
        return from_jax_limbs(arr, montgomery=True, curve=self.curve)


G1F = Field(PP.CurveId.BLS12_377, F.G1_CTX, JCTX, 30,
            JP.BLS12_377_BASE_FIELD, 304)
EDF = Field(PP.CurveId.EDWARDS_BLS12, F.ED_CTX,
            JF.field_ctx(JCurveId.EDWARDS_BLS12), 20,
            JP.EDWARDS_BLS12_BASE_FIELD, 48)
FIELDS = pytest.mark.parametrize("fd", [G1F, EDF], ids=["", "ed"])


def redc(t: int) -> int:
    m = (-t * pow(P, -1, R)) % R
    return (t + m * P) // R


def jax_limbs(vals) -> jnp.ndarray:
    """ints < 2^390 -> (30, N) canonical 13-bit JAX limbs."""
    return jnp.asarray(
        np.array(
            [[(v >> (13 * i)) & 0x1FFF for v in vals] for i in range(30)],
            dtype=np.uint32,
        )
    )


def jax_value(arr) -> list[int]:
    """(30, N) JAX limbs (soft limbs allowed) -> ints."""
    a = np.asarray(arr).astype(object)
    return [sum(int(a[i, j]) << (13 * i) for i in range(30))
            for j in range(a.shape[1])]


def rand_below(rng, bound, n=N):
    return [rng.randrange(bound) for _ in range(n)]


@FIELDS
def test_params_match_jax_and_header(fd):
    mp, p, r = fd.ctx.params, fd.p, fd.r_full
    assert mp.p == fd.jax_p and mp.nw == fd.nw
    assert mp.r == r % p and mp.r2 == r * r % p
    assert (p * mp.n0 + 1) % (1 << 32) == 0
    assert (p * mp.n0_16 + 1) % (1 << 16) == 0
    # R/p keeps every REDC output of the formulas' bound products below
    # 2p; one word fewer would not (G1 at 12 words: R/p ~ 152 < 304)
    assert r // p > fd.max_bound and (r >> 32) // p < fd.max_bound
    header = (Path(PP.__file__).parent / "csrc" / "params.cuh").read_text()
    assert header == PP.params_header()
    if fd is EDF:
        # the Edwards constants sit behind MSM_CURVE_ED: 9 words, d R mod p
        assert (PP.EDWARDS_D, PP.EDWARDS_GENERATOR_X, PP.EDWARDS_GENERATOR_Y,
                PP.EDWARDS_SUBGROUP_CHARACTERISTIC) == (
            JP.EDWARDS_D, JP.EDWARDS_GENERATOR_X, JP.EDWARDS_GENERATOR_Y,
            JP.EDWARDS_SUBGROUP_CHARACTERISTIC)
        part = header[header.index("#ifdef MSM_CURVE_ED"):header.index("#else")]
        d_mont = PP.EDWARDS_D * mp.r % p
        words = ", ".join(f"0x{(d_mont >> (32 * i)) & 0xFFFFFFFF:08x}u"
                          for i in range(9))
        assert "#define MSM_NW 9" in part and words in part


def test_plane_roundtrip():
    rng = random.Random("plane")
    vals = rand_below(rng, R) + [0, R - 1, P]
    plane = F.ints_to_plane(vals)
    assert plane.shape == (13, len(vals))
    assert F.plane_to_ints(plane) == vals


# bound products the point formulas feed one Montgomery product
# (ops/curve.py), with a full-range stress case for each field.  G1: 1x1
# (entry), 4x4, 8x8, 6x16 (double: 96), 20x8 (double: 160).  Edwards
# (hwcd): 1x1, 2x2 and 4x4 (adds, double squares), 6x4 = 24 (X3, T3),
# 8x4 = 32 (double Z3), 6x8 = 48 (double X3)
MM_CASES = [(G1F, ka, kb) for ka, kb in
            [(1, 1), (4, 4), (8, 8), (6, 16), (20, 8), (1 << 10, 1 << 10)]] + [
    (EDF, ka, kb) for ka, kb in
    [(1, 1), (2, 2), (4, 4), (6, 4), (8, 4), (6, 8), (1 << 10, 1 << 10)]]


@pytest.mark.parametrize("fd,ka,kb", MM_CASES, ids=[
    f"{'ed-' if fd is EDF else ''}{ka}-{kb}" for fd, ka, kb in MM_CASES])
def test_mont_mul_is_exact_redc(fd, ka, kb):
    rng = random.Random(f"{'ed-' if fd is EDF else ''}mm-{ka}-{kb}")
    p, r = fd.p, fd.r_full
    a = rand_below(rng, ka * p)
    b = rand_below(rng, kb * p)
    got = F.plane_to_ints(F.mont_mul(fd.plane(a), fd.plane(b), fd.ctx))
    ninv = pow(p, -1, r)
    assert got == [(x * y + (-x * y * ninv) % r * p) // r for x, y in zip(a, b)]
    if ka * kb <= fd.max_bound:
        assert max(got) < 2 * p


@pytest.mark.parametrize(
    "bounds",
    # paired products of ops/curve.py: G1 add_lazy X3 (6*8 + 12*18 =
    # 264), Y3 (8*8 + 18*6 = 172), Z3 (8*6 + 6*6 = 84); affine pair 48
    [(6, 8, 12, 18), (8, 8, 18, 6), (8, 6, 6, 6), (6, 4, 4, 6)],
)
def test_mont_mul_pair_is_exact_redc(bounds):
    rng = random.Random(f"mmp-{bounds}")
    a, b, c, d = (rand_below(rng, k * P) for k in bounds)
    got = F.plane_to_ints(F.mont_mul_pair(*(F.ints_to_plane(v) for v in (a, b, c, d))))
    want = [redc(w * x + y * z) for w, x, y, z in zip(a, b, c, d)]
    assert got == want
    assert max(got) < 2 * P


@FIELDS
def test_mont_products_match_jax_mod_p(fd):
    """Montgomery forms of the same x, y in both radixes: the products
    agree mod p once JAX's x*2^(13 W) is carried to the port's x*R."""
    p, jctx = fd.p, fd.jctx
    rng = random.Random("mm-jax" if fd is G1F else "ed-mm-jax")
    xs, ys, us, vs = (rand_below(rng, p) for _ in range(4))

    def jm(vals):
        return fd.jax_limbs([v * fd.rj % p for v in vals])

    def pm(vals):
        return fd.plane([v * fd.r_full % p for v in vals])

    j1 = jax.jit(lambda a, b: JF.mont_mul(jctx, a, b))(jm(xs), jm(ys))
    j2 = jax.jit(lambda a, b, c, d: JF.mont_mul_pair(jctx, a, b, c, d))(
        jm(xs), jm(ys), jm(us), jm(vs)
    )
    p1 = F.mont_mul(pm(xs), pm(ys), fd.ctx)
    p2 = F.mont_mul_pair(pm(xs), pm(ys), pm(us), pm(vs), fd.ctx)
    canon = lambda t: [v % p for v in F.plane_to_ints(t)]  # noqa: E731
    assert canon(p1) == F.plane_to_ints(fd.carry(j1))
    assert canon(p2) == F.plane_to_ints(fd.carry(j2))
    assert F.plane_to_ints(F.from_mont(p1, fd.ctx)) == [
        x * y % p for x, y in zip(xs, ys)]


def test_lazy_ops_exact_and_match_jax():
    """lazy_add / triple / scale / sub / neg are exact integer ops in both
    packages: the same inputs give the same integers."""
    rng = random.Random("lazy")
    a = rand_below(rng, 2 * P)
    b = rand_below(rng, 2 * P)
    pa, pb = F.ints_to_plane(a), F.ints_to_plane(b)
    ja, jb = jax_limbs(a), jax_limbs(b)
    cases = [
        (F.lazy_add(pa, pb), JF.lazy_add(JCTX, ja, jb),
         [x + y for x, y in zip(a, b)]),
        (F.lazy_triple(pa), JF.lazy_triple(JCTX, ja), [3 * x for x in a]),
        (F.lazy_scale(pa, 8), JF.lazy_scale(JCTX, ja, 8), [8 * x for x in a]),
        (F.lazy_sub(pa, pb, 4), JF.lazy_sub(JCTX, ja, jb, 4),
         [x + 4 * P - y for x, y in zip(a, b)]),
        (F.lazy_neg(pb, 4), JF.lazy_neg(JCTX, jb, 4), [4 * P - y for y in b]),
    ]
    for got, jgot, want in cases:
        assert F.plane_to_ints(got) == want
        assert jax_value(jgot) == want


@pytest.mark.parametrize(
    "k,amax,bmax",
    # the call-site envelopes of tests/test_lazy_neg_exactness.py (a = 0
    # for lazy_neg), in units of p, with adversarial near-max b
    [(6, 0, 4.2), (4, 0, 2.0), (4, 1.04, 2.1), (12, 1.04, 9.4),
     (2, 1.04, 1.04), (6, 1.04, 3.2), (18, 1.04, 9.4)],
)
def test_lazy_sub_neg_k_choices_exact(k, amax, bmax):
    rng = random.Random(f"kchoice-{k}-{amax}-{bmax}")
    hb = int(bmax * P)
    bs = [rng.randrange(hb) for _ in range(24)]
    bs += [hb - 1 - rng.randrange(1 << 40) for _ in range(24)]
    pb = F.ints_to_plane(bs)
    if amax == 0:
        got = F.plane_to_ints(F.lazy_neg(pb, k))
        assert got == [k * P - v for v in bs]
    else:
        as_ = [rng.randrange(int(amax * P)) if i % 2 else rng.randrange(1 << 40)
               for i in range(len(bs))]
        got = F.plane_to_ints(F.lazy_sub(F.ints_to_plane(as_), pb, k))
        assert got == [x + k * P - y for x, y in zip(as_, bs)]


@pytest.mark.parametrize("bound", [2, 4, 20])
def test_field_canon(bound):
    rng = random.Random(f"canon-{bound}")
    vals = rand_below(rng, bound * P)
    vals += [0, P - 1, P, 2 * P - 1, bound * P - 1]
    if bound > 2:
        vals += [2 * P, bound * P - P]
    got = F.plane_to_ints(F.field_canon(F.ints_to_plane(vals), bound))
    assert got == [v % P for v in vals]
    jgot = jax.jit(lambda s: JF.field_canon(JCTX, s, bound))(
        jax_limbs(vals)
    )
    assert jax_value(jgot) == got


@FIELDS
def test_mont_entry_exit_and_neg(fd):
    p, r, ctx = fd.p, fd.r_full, fd.ctx
    rng = random.Random("mont-rt" if fd is G1F else "ed-mont-rt")
    xs = rand_below(rng, p) + [0, 1, p - 1]
    plane = fd.plane(xs)
    m = F.to_mont(plane, ctx)
    assert F.plane_to_ints(m) == [x * r % p for x in xs]
    assert F.plane_to_ints(F.from_mont(m, ctx)) == xs
    assert F.plane_to_ints(F.field_neg(plane, ctx)) == [(-x) % p for x in xs]
    # to_mont is canonical for any input below R
    big = fd.plane(rand_below(rng, r, 16) + [r - 1])
    assert all(v < p for v in F.plane_to_ints(F.to_mont(big, ctx)))


def test_field_add_sub_match_jax_and_ints():
    """Canonical add and subtract: the same canonical inputs give the same
    canonical integers in both packages, with the wrap lanes (a + b >= p,
    a < b, equal operands, zero) included."""
    rng = random.Random("field-addsub")
    a = rand_below(rng, P) + [0, P - 1, P - 1, 5, 0, 7]
    b = rand_below(rng, P) + [0, P - 1, 1, P - 1, P - 1, 7]
    pa, pb = F.ints_to_plane(a), F.ints_to_plane(b)
    ja, jb = jax_limbs(a), jax_limbs(b)
    got_add = F.plane_to_ints(F.field_add(pa, pb))
    got_sub = F.plane_to_ints(F.field_sub(pa, pb))
    assert got_add == [(x + y) % P for x, y in zip(a, b)]
    assert got_sub == [(x - y) % P for x, y in zip(a, b)]
    assert jax_value(jax.jit(lambda s, t: JF.field_add(JCTX, s, t))(ja, jb)) == got_add
    assert jax_value(jax.jit(lambda s, t: JF.field_sub(JCTX, s, t))(ja, jb)) == got_sub


def test_mont_mul_canon_and_is_zero():
    rng = random.Random("mm-canon")
    a = rand_below(rng, P) + [0, P - 1]
    b = rand_below(rng, P) + [P - 1, P - 1]
    got = F.plane_to_ints(F.mont_mul_canon(F.ints_to_plane(a), F.ints_to_plane(b)))
    assert got == [x * y * pow(R, -1, P) % P for x, y in zip(a, b)]
    zeros = F.is_zero(F.ints_to_plane([0, 1, 1 << 400, 0]))
    assert zeros.tolist() == [True, False, False, True]
