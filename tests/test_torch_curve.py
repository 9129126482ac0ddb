"""Port G1 point formulas, lazy and canonical
(webgpu_msm_bls12_377_tpu_torch/ops/curve.py), against the JAX package's
ops/curve.py:G1Ops and the bigint oracle.

Both packages run the same complete RCB formulas in Montgomery form, so on
the same points the canonical outputs agree coordinate by coordinate mod p
(after JAX's x*2^390 is carried to the port's x*2^416), and they equal the
oracle's sums as projective points.  The port's inputs carry extra
multiples of p (lazy values up to 4p) that JAX's canonical inputs do not.
Lanes cover generic adds, doubling (P + P), inverses (P + -P) and the
identity on either side.  Exact integer comparisons: no tolerance.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu.ops import curve as JC
from webgpu_msm_bls12_377_tpu.reference import curve as jcrv
from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops.convert import from_jax_limbs
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv

# tiny tensors: one intra-op thread avoids oversubscribing the CPU
# beside the other test workers
torch.set_num_threads(1)

P = F.P
R = 1 << 416
RJ = 1 << 390
RINV = pow(R, -1, P)
JG1 = JC.G1Ops()
G1 = C.G1Ops()


def jax_limbs(vals):
    return jnp.asarray(np.array(
        [[(v >> (13 * i)) & 0x1FFF for v in vals] for i in range(30)],
        dtype=np.uint32,
    ))


def rand_point(rng):
    pt = crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 64))
    lam = rng.randrange(1, P)  # a random projective representative
    return crv.ProjectivePoint(pt.x * lam % P, pt.y * lam % P, pt.z * lam % P)


def lanes(rng, n=6):
    """(first, second) projective operand lists covering the edge lanes."""
    a = [rand_point(rng) for _ in range(n)]
    b = [rand_point(rng) for _ in range(n)]
    a += [a[0], a[1], crv.G1_ZERO, a[2], crv.G1_ZERO]
    b += [a[0], crv.g1_neg(a[1]), a[3], crv.G1_ZERO, crv.G1_ZERO]
    return a, b


def port_point(pts, rng=None):
    """Montgomery ProjG1 planes; with rng, each coordinate gets 0..3
    extra multiples of p (lazy values < 4p)."""
    cols = []
    for c in "xyz":
        vals = [getattr(p, c) * R % P for p in pts]
        if rng is not None:
            vals = [v + rng.randrange(4) * P for v in vals]
        cols.append(F.ints_to_plane(vals))
    return C.ProjG1(*cols)


def jax_point(pts):
    return JC.ProjG1(*(jax_limbs([getattr(p, c) * RJ % P for p in pts])
                       for c in "xyz"))


def port_ints(pt):
    return [F.plane_to_ints(c) for c in pt]


def jax_ints(pt):
    return [F.plane_to_ints(from_jax_limbs(c, montgomery=True)) for c in pt]


def as_oracle(cols):
    return [crv.ProjectivePoint(*(v * RINV % P for v in t)) for t in zip(*cols)]


def check(got_port, got_jax, want):
    assert got_port == got_jax
    for g, w in zip(as_oracle(got_port), want):
        assert crv.g1_eq(g, w)


def test_zero_and_from_affine():
    z = port_ints(G1.zero(3))
    assert z == [[0] * 3, [R % P] * 3, [0] * 3]
    x = F.ints_to_plane([5, 7])
    y = F.ints_to_plane([11, 13])
    assert port_ints(G1.from_affine((x, y))) == [[5, 7], [11, 13], [R % P] * 2]


def test_add_lazy_pair_matches_jax_and_oracle():
    rng = random.Random("curve-add")
    a, b = lanes(rng)
    got = port_ints(G1.canon(G1.add_lazy(port_point(a, rng),
                                              port_point(b, rng))))
    jgot = jax.jit(lambda p, q: JG1.canon(JG1.add_lazy(p, q)))(
        jax_point(a), jax_point(b)
    )
    check(got, jax_ints(jgot), [crv.g1_add(p, q) for p, q in zip(a, b)])


def test_add_affine_lazy_pair_matches_jax_and_oracle():
    rng = random.Random("curve-aff")
    a = [rand_point(rng) for _ in range(6)]
    b = [rand_point(rng) for _ in range(6)]
    a += [a[0], a[1]]
    b += [a[0], crv.g1_neg(a[1])]  # doubling and inverse lanes
    aff_a = [crv.g1_to_affine(p) for p in a]
    aff_b = [crv.g1_to_affine(p) for p in b]

    def port_aff(affs):
        return tuple(F.ints_to_plane([v[i] * R % P for v in affs])
                     for i in range(2))

    def jax_aff(affs):
        return tuple(jax_limbs([v[i] * RJ % P for v in affs]) for i in range(2))

    got = port_ints(G1.canon(G1.add_affine_lazy(port_aff(aff_a),
                                                     port_aff(aff_b))))
    jgot = jax.jit(lambda p, q: JG1.canon(JG1.add_affine_lazy(p, q)))(
        jax_aff(aff_a), jax_aff(aff_b)
    )
    check(got, jax_ints(jgot), [crv.g1_add(p, q) for p, q in zip(a, b)])


def test_double_lazy_matches_jax_and_oracle():
    rng = random.Random("curve-dbl")
    a = [rand_point(rng) for _ in range(6)] + [crv.G1_ZERO]
    got = port_ints(G1.canon(G1.double_lazy(port_point(a, rng))))
    jgot = jax.jit(lambda p: JG1.canon(JG1.double_lazy(p)))(jax_point(a))
    check(got, jax_ints(jgot), [crv.g1_double(p) for p in a])


def test_lazy_chains_stay_closed():
    """Outputs of every form feed the next without reduction (inputs < 4p
    -> outputs < 4p): a chain of adds and doubles equals the oracle."""
    rng = random.Random("curve-chain")
    a, b = lanes(rng)
    pa, pb = port_point(a, rng), port_point(b, rng)
    want_a, want_b = list(a), list(b)
    for _ in range(3):
        pa = G1.add_lazy(pa, pb)
        pb = G1.double_lazy(pb)
        want_a = [crv.g1_add(p, q) for p, q in zip(want_a, want_b)]
        want_b = [crv.g1_double(q) for q in want_b]
        for c in (*pa, *pb):
            assert max(F.plane_to_ints(c)) < 4 * P
    for g, w in zip(as_oracle(port_ints(G1.canon(pa))), want_a):
        assert crv.g1_eq(g, w)


def affine_lanes(rng):
    """(accumulator, addend) lists for the mixed adds: the addend is never
    the identity; the accumulator covers equal, inverse and identity lanes."""
    b = [rand_point(rng) for _ in range(8)]
    a = [rand_point(rng) for _ in range(5)] + [b[5], crv.g1_neg(b[6]), crv.G1_ZERO]
    return a, b


def port_aff(pts):
    affs = [crv.g1_to_affine(p) for p in pts]
    return tuple(F.ints_to_plane([v[i] * R % P for v in affs]) for i in range(2))


def jax_aff(pts):
    affs = [crv.g1_to_affine(p) for p in pts]
    return tuple(jax_limbs([v[i] * RJ % P for v in affs]) for i in range(2))


def test_add_mixed_lazy_pair_matches_jax_and_oracle():
    rng = random.Random("curve-mixed-lazy")
    a, b = affine_lanes(rng)
    out = G1.add_mixed_lazy(port_point(a, rng), port_aff(b))
    assert all(v < 2 * P for c in out for v in F.plane_to_ints(c))
    jgot = jax.jit(lambda p, q: JG1.canon(JG1.add_mixed_lazy(p, q)))(
        jax_point(a), jax_aff(b)
    )
    check(port_ints(G1.canon(out)), jax_ints(jgot),
          [crv.g1_add(p, q) for p, q in zip(a, b)])


def test_canonical_add_mixed_and_neg_affine_match_jax_and_oracle():
    rng = random.Random("curve-mixed")
    a, b = affine_lanes(rng)
    got = port_ints(G1.add_mixed(port_point(a), G1.neg_affine(port_aff(b))))
    jgot = jax.jit(lambda p, q: JG1.add_mixed(p, JG1.neg_affine(q)))(
        jax_point(a), jax_aff(b)
    )
    assert all(v < P for c in got for v in c)
    check(got, jax_ints(jgot),
          [crv.g1_add(p, crv.g1_neg(q)) for p, q in zip(a, b)])


def test_canonical_add_matches_jax_and_oracle():
    rng = random.Random("curve-canon-add")
    a, b = lanes(rng)
    got = port_ints(G1.add(port_point(a), port_point(b)))
    jgot = jax.jit(JG1.add)(jax_point(a), jax_point(b))
    assert all(v < P for c in got for v in c)
    check(got, jax_ints(jgot), [crv.g1_add(p, q) for p, q in zip(a, b)])


def test_canonical_double_and_is_zero_match_jax_and_oracle():
    rng = random.Random("curve-canon-dbl")
    a = [rand_point(rng) for _ in range(6)] + [crv.G1_ZERO]
    got = port_ints(G1.double(port_point(a)))
    jgot = jax.jit(JG1.double)(jax_point(a))
    check(got, jax_ints(jgot), [crv.g1_double(p) for p in a])
    assert G1.is_zero(port_point(a)).tolist() == \
        np.asarray(JG1.is_zero(jax_point(a))).reshape(-1).tolist() == \
        [False] * 6 + [True]


def test_canonical_neg_matches_jax_and_oracle():
    rng = random.Random("curve-canon-neg")
    a = [rand_point(rng) for _ in range(6)] + [crv.G1_ZERO]
    got = port_ints(G1.neg(port_point(a)))
    check(got, jax_ints(JG1.neg(jax_point(a))), [crv.g1_neg(p) for p in a])


@pytest.mark.parametrize("k", [1, 2, 3, 1 << 61])
def test_scalar_mult_oracle_matches_jax_oracle(k):
    """The port's own bigint oracle agrees with the JAX package's."""
    mine = crv.g1_to_affine(crv.g1_scalar_mult(crv.G1_GENERATOR, k))
    theirs = jcrv.g1_to_affine(jcrv.g1_scalar_mult(jcrv.G1_GENERATOR, k))
    assert mine == theirs
