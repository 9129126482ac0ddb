"""Port plan stages against the JAX package's, exactly.

mont_point_table (compared mod p, canonical in both), the signed window
decomposition, the bucket plan (stable per-window sort: sorted_vals,
starts and lens entry for entry), the hybrid plan (phantom-extended
lengths, level maps with JAX's window-local loc/m turned into absolute
child indices, and the finish layout) and build_stream_layout.  Runs at
chunk 4 and chunk 9, on random and duplicate-heavy scalar sets.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu.models import cuzk as jcuzk
from webgpu_msm_bls12_377_tpu.ops import buckets as jbuck
from webgpu_msm_bls12_377_tpu.ops import curve as jcurve
from webgpu_msm_bls12_377_tpu.ops import decompose as jdec
from webgpu_msm_bls12_377_tpu.ops import smvp_stream as jss
from webgpu_msm_bls12_377_tpu.ops import smvp_tree as jst
from webgpu_msm_bls12_377_tpu_torch.models import cuzk
from webgpu_msm_bls12_377_tpu_torch.ops import buckets, decompose, smvp_stream, smvp_tree
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops.convert import from_jax_limbs, ints_to_words
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv

# tiny tensors: one intra-op thread avoids oversubscribing the CPU
# beside the other test workers
torch.set_num_threads(1)

N = 96
P = F.P
JG1 = jcurve.G1Ops()
# (chunk, JAX finish lanes): the JAX layout's lanes must divide the
# 2^(chunk-1) buckets/window; the port's layout is flat
CHUNKS = [(4, 8), (9, 32)]


def scalar_set(kind: str) -> list[int]:
    rng = random.Random(f"plan-{kind}")
    if kind == "random":
        return [rng.randrange(0, 1 << 253) for _ in range(N)]
    if kind == "dup":  # every scalar equal: one bucket per window holds all
        return [0x1234_5678_9ABC_DEF0] * N
    pool = [rng.randrange(0, 1 << 253) for _ in range(3)]  # few distinct
    return [pool[min(int(rng.expovariate(1.0)), 2)] for _ in range(N)]


def as_np(t) -> np.ndarray:
    return np.asarray(t).astype(np.int64)


@pytest.fixture(scope="module")
def point_words():
    rng = random.Random("plan-points")
    aff = [crv.g1_to_affine(crv.g1_scalar_mult(crv.G1_GENERATOR,
                                               rng.randrange(1, 1 << 60)))
           for _ in range(N)]
    return np.stack([ints_to_words([a[0] for a in aff], 12),
                     ints_to_words([a[1] for a in aff], 12)])


def test_mont_point_table_matches_jax(point_words):
    want = jcuzk.mont_point_table(JG1.ctx, JG1, jnp.asarray(point_words))
    got = cuzk.mont_point_table(torch.from_numpy(point_words.view(np.int32)))
    want = from_jax_limbs(np.asarray(want).reshape(60, N), montgomery=True)
    assert torch.equal(got, want)


def test_chunk_policy_matches_jax():
    for c in range(2, 21):
        assert decompose.num_windows_for(c) == jcuzk.num_windows_for(c)
    for n in (1, 1 << 15, 1 << 16, 1 << 19, 1 << 20, 1 << 22):
        assert decompose.choose_chunk_size(n) == jcuzk.choose_chunk_size(n)


def _plans(kind, chunk):
    sw = ints_to_words(scalar_set(kind), 8)
    nw = decompose.num_windows_for(chunk)
    jd = jdec.decompose_scalars_signed(jnp.asarray(sw), chunk, nw)
    pd = decompose.decompose_scalars_signed(
        torch.from_numpy(sw.view(np.int32)), chunk, nw
    )
    return nw, jd, pd, jbuck.build_bucket_plan(jd, chunk), \
        buckets.build_bucket_plan(pd, chunk)


@pytest.mark.parametrize("kind", ["random", "dup", "few"])
@pytest.mark.parametrize("chunk,lanes", CHUNKS)
def test_decompose_and_bucket_plan_match_jax(kind, chunk, lanes):
    _, jd, pd, jplan, pplan = _plans(kind, chunk)
    assert np.array_equal(as_np(jd), pd.numpy())
    for name in ("sorted_vals", "starts", "lens"):
        assert np.array_equal(as_np(getattr(jplan, name)),
                              getattr(pplan, name).numpy()), name


def _absolute_jax_map(loc, m, t_real):
    """JAX window-local (loc, m) -> (absolute childA, single) over the
    first t_real slots, plus JAX's invalid mask over all its slots."""
    loc, m = as_np(loc), as_np(m)
    p = np.arange(t_real)
    child = (loc[:t_real] & jst.LOC_MASK) + jst.BLOCK * m[p // jst.BLOCK]
    single = (loc[:t_real] & jst.FLAG_SINGLE) != 0
    return child, single, loc == jst.FLAG_INVALID


def _check_level_map(jloc, jm, pmap, t_real):
    child, single, jinvalid = _absolute_jax_map(jloc, jm, t_real)
    pmap = pmap.numpy().astype(np.int64)
    assert not jinvalid[:t_real].any() and jinvalid[t_real:].all()
    assert np.array_equal(pmap[:t_real] & smvp_tree.CHILD_MASK, child)
    assert np.array_equal((pmap[:t_real] & smvp_tree.FLAG_SINGLE) != 0, single)
    assert not (pmap[:t_real] & smvp_tree.FLAG_INVALID).any()
    assert (pmap[t_real:] == smvp_tree.FLAG_INVALID).all()


@pytest.mark.parametrize("kind", ["random", "dup", "few"])
@pytest.mark.parametrize("chunk,lanes", CHUNKS)
def test_hybrid_plan_matches_jax(kind, chunk, lanes):
    nw, _, _, jplan, pplan = _plans(kind, chunk)
    kn = N * nw
    k_levels = 2
    jh = jst.build_hybrid_plan(jplan.starts, jplan.lens, kn, k_levels, nw, lanes)
    ph = smvp_tree.build_hybrid_plan(pplan.starts, pplan.lens, kn, k_levels, nw)
    assert np.array_equal(as_np(jh.lens), ph.lens.numpy())
    # level 1: JAX's loc1/m1 decoded to absolute child indices
    c1, s1 = smvp_tree.chain_counts(ph.lens, 1)
    t1 = int(s1[-1] + c1[-1])
    _check_level_map(jh.loc1, jh.m1, ph.level_map1, t1)
    # level 2, built by both packages from the same chains
    c2, s2 = smvp_tree.chain_counts(ph.lens, 2)
    t2 = int(s2[-1] + c2[-1])
    t_cls = jst.level_classes(kn, ph.lens.shape[0], 2)
    jloc, jm, _ = jst.build_level_map(
        *(jnp.asarray(v.numpy(), jnp.int32) for v in (s1, c1, s2, c2)),
        t_cls[1], t_cls[0] // jst.BLOCK, 3,
    )
    caps = smvp_tree.level_caps(kn, ph.lens.shape[0], 2)
    pmap2 = smvp_tree.build_level_map(s1, c1, s2, c2, caps[1])
    _check_level_map(jloc, jm, pmap2, t2)
    # the finish layout over the level-K packed segments
    for name in ("starts_rk", "lens_rk", "perm"):
        assert np.array_equal(as_np(getattr(jh.layout, name)).reshape(-1),
                              getattr(ph.layout, name).numpy()), name


@pytest.mark.parametrize("chunk,lanes", CHUNKS)
def test_stream_layout_matches_jax(chunk, lanes):
    """build_stream_layout on the raw bucket segments (ties in length
    keep bucket order: both sorts are stable)."""
    nw, _, _, jplan, pplan = _plans("few", chunk)
    jl = jss.build_stream_layout(jplan.starts, jplan.lens, nw, lanes)
    pl = smvp_stream.build_stream_layout(pplan.starts, pplan.lens, nw)
    for name in ("starts_rk", "lens_rk", "perm"):
        assert np.array_equal(as_np(getattr(jl, name)).reshape(-1),
                              getattr(pl, name).numpy()), name


def test_level_caps_bound_real_counts():
    """The static plane sizes bound the real node counts for any lens."""
    rng = np.random.default_rng(7)
    for _ in range(20):
        lens = torch.from_numpy(rng.integers(0, 40, size=64))
        kn = int(lens.sum())
        caps = smvp_tree.level_caps(kn, 64, 4)
        for k, cap in enumerate(caps, start=1):
            c, s = smvp_tree.chain_counts(lens, k)
            assert int(s[-1] + c[-1]) <= cap
