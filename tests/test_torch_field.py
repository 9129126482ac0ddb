"""Port field layer (webgpu_msm_bls12_377_tpu_torch/ops/field.py) against
exact bigint arithmetic and the JAX package's ops/field.py.

The port's values are exact integers below 2^416 (13 x 32-bit words,
R = 2^416), so its Montgomery products are checked for exact equality with
REDC(T) = (T + m p) / R, and its lazy add/sub/neg for exact equality with
the integer expressions.  Against JAX (30 x 13-bit limbs, R = 2^390) the
comparison is mod p at canonical boundaries, through from_jax_limbs.
Every comparison is exact integer equality: no tolerance applies.
"""

import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_params_match_jax_and_header():
    from webgpu_msm_bls12_377_tpu.params import BLS12_377_BASE_FIELD

    mp = PP.BLS12_377_PARAMS
    assert mp.p == BLS12_377_BASE_FIELD
    assert mp.r == R % P and mp.r2 == R * R % P
    assert (P * mp.n0 + 1) % (1 << 32) == 0
    assert (P * mp.n0_16 + 1) % (1 << 16) == 0
    header = Path(PP.__file__).parent / "csrc" / "params.cuh"
    assert header.read_text() == PP.params_header()


def test_plane_roundtrip():
    rng = random.Random("plane")
    vals = rand_below(rng, R) + [0, R - 1, P]
    plane = F.ints_to_plane(vals)
    assert plane.shape == (13, len(vals))
    assert F.plane_to_ints(plane) == vals


@pytest.mark.parametrize(
    "ka,kb",
    # bound products the point formulas feed one Montgomery product
    # (ops/curve.py): 1x1 (entry), 4x4, 8x8, 6x16 (double: 96),
    # 20x8 (double: 160), and a full-range stress case
    [(1, 1), (4, 4), (8, 8), (6, 16), (20, 8), (1 << 10, 1 << 10)],
)
def test_mont_mul_is_exact_redc(ka, kb):
    rng = random.Random(f"mm-{ka}-{kb}")
    a = rand_below(rng, ka * P)
    b = rand_below(rng, kb * P)
    got = F.plane_to_ints(F.mont_mul(F.ints_to_plane(a), F.ints_to_plane(b)))
    want = [redc(x * y) for x, y in zip(a, b)]
    assert got == want
    if ka * kb <= 304:
        assert max(got) < 2 * P


@pytest.mark.parametrize(
    "bounds",
    # paired products of ops/curve.py: add_lazy_pair X3 (6*8 + 12*18 =
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


def test_mont_products_match_jax_mod_p():
    """Montgomery forms of the same x, y in both radixes: the products
    agree mod p once JAX's x*2^390 is carried to the port's x*2^416."""
    rng = random.Random("mm-jax")
    xs, ys, us, vs = (rand_below(rng, P) for _ in range(4))

    def jm(vals):
        return jax_limbs([v * RJ % P for v in vals])

    def pm(vals):
        return F.ints_to_plane([v * R % P for v in vals])

    j1 = jax.jit(lambda a, b: JF.mont_mul(JCTX, a, b))(jm(xs), jm(ys))
    j2 = jax.jit(lambda a, b, c, d: JF.mont_mul_pair(JCTX, a, b, c, d))(
        jm(xs), jm(ys), jm(us), jm(vs)
    )
    p1 = F.mont_mul(pm(xs), pm(ys))
    p2 = F.mont_mul_pair(pm(xs), pm(ys), pm(us), pm(vs))
    canon = lambda t: [v % P for v in F.plane_to_ints(t)]  # noqa: E731
    assert canon(p1) == F.plane_to_ints(from_jax_limbs(j1, montgomery=True))
    assert canon(p2) == F.plane_to_ints(from_jax_limbs(j2, montgomery=True))


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


def test_mont_entry_exit_and_neg():
    rng = random.Random("mont-rt")
    xs = rand_below(rng, P) + [0, 1, P - 1]
    plane = F.ints_to_plane(xs)
    m = F.to_mont(plane)
    assert F.plane_to_ints(m) == [x * R % P for x in xs]
    assert F.plane_to_ints(F.from_mont(m)) == xs
    assert F.plane_to_ints(F.field_neg(plane)) == [(-x) % P for x in xs]
    # to_mont is canonical for any 416-bit input
    big = F.ints_to_plane(rand_below(rng, R, 16) + [R - 1])
    assert all(v < P for v in F.plane_to_ints(F.to_mont(big)))
