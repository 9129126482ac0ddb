"""Port Twisted Edwards BLS12 (a = -1, d = 3021) against the JAX package and
the bigint oracle, where no G1 test has a counterpart: the hwcd lazy forms
against the JAX EdwardsOps, and the engine end to end on the tree and
stream paths and the public entry point (CPU, plain PyTorch versions of
every kernel); tests/test_torch_edwards_canon.py holds the canonical
forms, the fused and legacy paths and the baseline engines.  The field
and the SMVP stages run for both curves in tests/test_torch_field.py and
tests/test_torch_smvp_bpr.py.

The port's Edwards values are exact integers below 2^288 (9 x 32-bit
words, R = 2^288); the JAX package's are 20 x 13-bit limbs (R = 2^260).
JAX state crosses with from_jax_limbs(..., curve=EDWARDS_BLS12) (x*2^260
-> x*2^288) and is compared mod p at canonical boundaries.  The JAX forms
are its jnp EdwardsOps, as its own CPU tests run them; the engine is held
against the JAX compute_msm_edwards (its legacy path off a TPU).  Every
comparison is exact integer equality: no tolerance applies.
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu import compute_msm_edwards as jax_compute_msm_edwards
from webgpu_msm_bls12_377_tpu.ops import curve as jcurve
import webgpu_msm_bls12_377_tpu_torch as port
from webgpu_msm_bls12_377_tpu_torch.models import CuzkMsmEngine
from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops.convert import from_jax_limbs, ints_to_words
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import EDWARDS, naive_msm

# tiny tensors: one intra-op thread avoids oversubscribing the CPU
# beside the other test workers
torch.set_num_threads(1)

ED = C.EDWARDS
CTX = F.ED_CTX
P = CTX.p
NWD = CTX.nw  # 9 words
R = 1 << 288
W = 20  # JAX limbs per Edwards field element
RJ = 1 << (13 * W)
JED = jcurve.EdwardsOps()
CHUNK = 4
THREADS = 4
N = 48


def plane(vals) -> torch.Tensor:
    return F.ints_to_plane(vals, nw=NWD)


def jax_plane(vals) -> jnp.ndarray:
    """ints < 2^260 -> (20, n) canonical 13-bit JAX limbs."""
    return jnp.asarray(np.array(
        [[(v >> (13 * i)) & 0x1FFF for v in vals] for i in range(W)],
        dtype=np.uint32))


def carry(pt) -> torch.Tensor:
    """JAX Edwards coordinate planes (a tuple, or a merged (k*20, n)
    plane) -> the port's canonical (k*9, n) plane."""
    arr = np.concatenate([np.asarray(c) for c in pt]) if isinstance(
        pt, tuple) else np.asarray(pt)
    return from_jax_limbs(arr, montgomery=True, curve=CurveId.EDWARDS_BLS12)


def mod_p(pl: torch.Tensor) -> list[list[int]]:
    return [[v % P for v in F.plane_to_ints(pl[c * NWD:(c + 1) * NWD])]
            for c in range(pl.shape[0] // NWD)]


def rand_points(rng, n):
    return [crv.ed_scalar_mult(crv.ED_GENERATOR, rng.randrange(1, 1 << 60))
            for _ in range(n)]


# -- the hwcd lazy forms ----------------------------------------------------


def lazy_lanes(rng, pts, lazy):
    """Port ExtEd (Montgomery, coordinates below 2p where lazy) and the
    JAX ExtEd of the same values mod p."""
    cols = list(zip(*[(p.x, p.y, p.t, p.z) for p in pts]))
    port_c, jax_c = [], []
    for vals in cols:
        pv = [v * R % P + (P if lazy and rng.random() < 0.5 else 0)
              for v in vals]
        port_c.append(plane(pv))
        jax_c.append(jax_plane([v * RJ % P for v in vals]))
    return C.ExtEd(*port_c), jcurve.ExtEd(*jax_c)


def affine_lanes(pts):
    aff = [crv.ed_to_affine(p) for p in pts]
    vals = [(x, y, x * y % P) for x, y in aff]
    port_a = tuple(plane([v[c] * R % P for v in vals]) for c in range(3))
    jax_a = tuple(jax_plane([v[c] * RJ % P for v in vals]) for c in range(3))
    return port_a, jax_a, [crv.ed_from_affine(*a) for a in aff]


def as_oracle(pt: C.ExtEd) -> list:
    cols = [[v * pow(R, -1, P) % P for v in F.plane_to_ints(c)] for c in pt]
    return [crv.ExtendedPoint(*v) for v in zip(*cols)]


@pytest.mark.parametrize("form", ["add_mixed_lazy", "add_affine_lazy",
                                  "add_lazy", "double_lazy"])
def test_edwards_lazy_forms_match_jax_and_oracle(form):
    """Each hwcd lazy form on the same inputs (accumulators below 2p, the
    identity among them; affine addends canonical) equals the JAX form
    coordinate by coordinate mod p and the oracle as a point; outputs stay
    below 2p and canon makes them canonical."""
    rng = random.Random(f"ed-{form}")
    p1 = rand_points(rng, 7) + [crv.ED_ZERO]
    p2 = rand_points(rng, 7) + [p1[0]]  # one lane doubles through the add
    port1, jax1 = lazy_lanes(rng, p1, lazy=True)
    port2, jax2 = lazy_lanes(rng, p2, lazy=True)
    aff1, jaff1, _ = affine_lanes(p1[:7] + p2[:1])
    aff2, jaff2, oaff2 = affine_lanes(p2)
    if form == "add_mixed_lazy":
        got, want = ED.add_mixed_lazy(port1, aff2), JED.add_mixed_lazy(jax1, jaff2)
        oracle = [crv.ed_add(a, b) for a, b in zip(p1, oaff2)]
    elif form == "add_affine_lazy":
        got, want = ED.add_affine_lazy(aff1, aff2), JED.add_affine_lazy(jaff1, jaff2)
        oracle = [crv.ed_add(a, b) for a, b in zip(p1[:7] + p2[:1], oaff2)]
    elif form == "add_lazy":
        got, want = ED.add_lazy(port1, port2), JED.add_lazy(jax1, jax2)
        oracle = [crv.ed_add(a, b) for a, b in zip(p1, p2)]
    else:
        got, want = ED.double_lazy(port1), JED.double_lazy(jax1)
        oracle = [crv.ed_double(a) for a in p1]
    merged = C.merge(got)
    assert all(v < 2 * P for c in got for v in F.plane_to_ints(c))
    assert mod_p(merged) == mod_p(carry(tuple(want)))
    assert all(crv.ed_eq(a, b) for a, b in zip(as_oracle(got), oracle))
    canon = ED.canon(got)
    assert all(v < P for c in canon for v in F.plane_to_ints(c))
    assert mod_p(C.merge(canon)) == mod_p(merged)


def test_edwards_lazy_chains_stay_closed():
    """Forty chained lazy adds and doubles keep every coordinate below 2p
    and the oracle's point; zero, from_affine and neg_affine as the JAX
    package defines them."""
    rng = random.Random("ed-chain")
    pts = rand_points(rng, 6)
    aff, _, oaff = affine_lanes(pts)
    acc, want = ED.zero(6), [crv.ED_ZERO] * 6
    for step in range(40):
        if step % 3 == 2:
            acc, want = ED.double_lazy(acc), [crv.ed_double(w) for w in want]
        elif step % 3 == 1:
            acc = ED.add_lazy(acc, ED.from_affine(aff))
            want = [crv.ed_add(w, a) for w, a in zip(want, oaff)]
        else:
            acc = ED.add_mixed_lazy(acc, ED.neg_affine(aff))
            want = [crv.ed_add(w, crv.ed_neg(a)) for w, a in zip(want, oaff)]
        assert all(v < 2 * P for c in acc for v in F.plane_to_ints(c))
    assert all(crv.ed_eq(a, b) for a, b in zip(as_oracle(acc), want))
    zero = JED.zero((3,))
    assert torch.equal(C.merge(ED.zero(3)), carry(tuple(zero)))


# -- the engine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def case():
    rng = random.Random("ed-engine")
    pts = rand_points(rng, N)
    scalars = [rng.randrange(0, 1 << 253) for _ in range(N)]
    scalars[0], scalars[1], scalars[2] = 0, 1, (1 << 253) - 1
    aff = [crv.ed_to_affine(p) for p in pts]
    want = crv.ed_to_affine(naive_msm(pts, scalars, EDWARDS))
    jax_got = jax_compute_msm_edwards(aff, scalars)
    assert (jax_got["x"], jax_got["y"]) == want
    return dict(pts=pts, aff=aff, scalars=scalars, want=jax_got)


def engine(**kw):
    opts = dict(chunk_size=CHUNK, num_bpr_threads=THREADS, device="cpu")
    opts.update(kw)
    return CuzkMsmEngine(CurveId.EDWARDS_BLS12, **opts)


@pytest.mark.parametrize("mode,finish", [("tree", 1), ("tree", 2),
                                         ("tree", None), ("stream", None)],
                         ids=["hybrid-K1", "hybrid-K2", "pure-tree", "stream"])
def test_edwards_engine_matches_jax_and_oracle(case, mode, finish):
    got = engine(smvp_mode=mode, tree_finish=finish).compute_msm(
        case["aff"], case["scalars"])
    assert got == case["want"]


def test_compute_msm_edwards_entry_point(case, monkeypatch):
    """The public entry point with its default policy: below 2^16 (chunk
    4, the fused path, 512 BPR threads) and at chunk 9 ("auto" takes the
    stream path, as from 2^16) it equals the JAX engine, for int pairs,
    64-byte point buffers and word arrays alike."""
    aff, scalars = case["aff"], case["scalars"]
    assert port.compute_msm_edwards(aff, scalars, device="cpu") == case["want"]
    monkeypatch.setattr(CuzkMsmEngine, "_chunk_for", lambda self, n: 9)
    # 4 BPR threads in place of 512 keep the plain forms quick
    monkeypatch.setattr(CuzkMsmEngine, "__init__", functools.partialmethod(
        CuzkMsmEngine.__init__, num_bpr_threads=THREADS))
    pbuf = b"".join(x.to_bytes(32, "little") + y.to_bytes(32, "little")
                    for x, y in aff)
    sbuf = b"".join(s.to_bytes(32, "little") for s in scalars)
    # 12 points: at chunk 9 the top window holds one scalar bit, so its
    # two buckets hold every entry and set the plain stream's rounds
    got = port.compute_msm_edwards(pbuf[:12 * 64], sbuf[:12 * 32], device="cpu")
    want = crv.ed_to_affine(naive_msm(case["pts"][:12], scalars[:12], EDWARDS))
    assert (got["x"], got["y"]) == want
    words = np.stack([ints_to_words([a[0] for a in aff], 8),
                      ints_to_words([a[1] for a in aff], 8)])
    eng = engine(smvp_mode="stream")
    assert eng.compute_msm(pbuf, list(scalars)) == case["want"]
    assert eng.compute_msm(words, ints_to_words(scalars, 8)) == case["want"]


@pytest.mark.parametrize("mode", ["tree", "stream"])
def test_edwards_batch_equals_per_set_msm(case, mode):
    rng = random.Random("ed-batch")
    sets = [case["scalars"]] + [[rng.randrange(0, 1 << 253) for _ in range(N)]
                                for _ in range(2)]
    eng = engine(smvp_mode=mode, tree_finish=2 if mode == "tree" else None)
    got = eng.compute_msm_batch(case["aff"], sets)
    assert got[0] == case["want"]
    for sc, g in zip(sets[1:], got[1:]):
        want = crv.ed_to_affine(naive_msm(case["pts"], sc, EDWARDS))
        assert (g["x"], g["y"]) == want
