"""Port SMVP stages and BPR against the JAX package, at canonical boundaries.

The JAX kernels' bodies are jnp point forms (ops/curve.py:G1Ops); on the
CPU the tier-1 tests run those forms directly, since interpret-mode
Pallas compiles take minutes.  Each stage gets the same input in both
packages: JAX-produced state (the Montgomery table, tree level planes,
bucket arrays) is carried into the port with from_jax_limbs, and the
outputs are compared mod p after canonicalization.  The plain PyTorch
versions of kernels 2, 3 and 4 run here; the kernels themselves are held
against those plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu.models import cuzk as jcuzk
from webgpu_msm_bls12_377_tpu.ops import bpr as jbpr
from webgpu_msm_bls12_377_tpu.ops import buckets as jbuck
from webgpu_msm_bls12_377_tpu.ops import curve as jcurve
from webgpu_msm_bls12_377_tpu.ops import decompose as jdec
from webgpu_msm_bls12_377_tpu.ops import smvp_stream as jss
from webgpu_msm_bls12_377_tpu.ops import smvp_tree as jst
from webgpu_msm_bls12_377_tpu_torch.ops import bpr, buckets, decompose
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream, smvp_tree
from webgpu_msm_bls12_377_tpu_torch.ops.convert import from_jax_limbs, ints_to_words
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv

# tiny tensors: one intra-op thread avoids oversubscribing the CPU
# beside the other test workers
torch.set_num_threads(1)

N = 96
CHUNK = 4
LANES = 8  # the JAX finish layout's lanes (the port's layout is flat)
THREADS = 4
P = F.P
JG1 = jcurve.G1Ops()
NW = decompose.num_windows_for(CHUNK)
W = 30  # JAX limbs per field element


def carry(pt) -> torch.Tensor:
    """JAX ProjG1 (or merged (k*30, T) plane) -> port canonical plane."""
    arr = np.concatenate([np.asarray(c) for c in pt]) if isinstance(
        pt, tuple) else np.asarray(pt)
    return from_jax_limbs(arr, montgomery=True)


def mod_p(plane: torch.Tensor) -> np.ndarray:
    """Port plane -> object array of its values mod p, one row per coord."""
    rows = [F.plane_to_ints(plane[c * F.NW:(c + 1) * F.NW])
            for c in range(plane.shape[0] // F.NW)]
    return np.array([[v % P for v in r] for r in rows], dtype=object)


def take(pt, idx):
    idx = jnp.asarray(idx)
    return type(pt)(*(jnp.take(c, idx, axis=1) for c in pt))


@pytest.fixture(scope="module")
def stage():
    """JAX plan state at N = 96, chunk 4, K = 2, plus the port's plans."""
    rng = random.Random("smvp-bpr")
    aff = [crv.g1_to_affine(crv.g1_scalar_mult(crv.G1_GENERATOR,
                                               rng.randrange(1, 1 << 60)))
           for _ in range(N)]
    pw = np.stack([ints_to_words([a[0] for a in aff], 12),
                   ints_to_words([a[1] for a in aff], 12)])
    sw = ints_to_words([rng.randrange(0, 1 << 253) for _ in range(N)], 8)
    table = jcuzk.mont_point_table(JG1.ctx, JG1, jnp.asarray(pw))
    jplan = jbuck.build_bucket_plan(
        jdec.decompose_scalars_signed(jnp.asarray(sw), CHUNK, NW), CHUNK)
    kn = N * NW
    jh = jst.build_hybrid_plan(jplan.starts, jplan.lens, kn, 2, NW, LANES)
    pplan = buckets.build_bucket_plan(
        decompose.decompose_scalars_signed(torch.from_numpy(sw.view(np.int32)),
                                           CHUNK, NW), CHUNK)
    ph = smvp_tree.build_hybrid_plan(pplan.starts, pplan.lens, kn, 2, NW)
    return dict(table=table, jplan=jplan, jh=jh, pplan=pplan, ph=ph, kn=kn)


def decode(level_map: torch.Tensor, t_real: int):
    m = level_map.numpy().astype(np.int64)[:t_real]
    child = m & smvp_tree.CHILD_MASK
    single = (m & smvp_tree.FLAG_SINGLE) != 0
    return child, np.where(single, child, child + 1), single


def jax_level1(s):
    """Level 1 in jnp: both-affine adds of sorted-stream children."""
    ph = s["ph"]
    c1, s1 = smvp_tree.chain_counts(ph.lens, 1)
    t1 = int(s1[-1] + c1[-1])
    ca, cb, single = decode(ph.level_map1, t1)
    ttab = jst.build_tree_table(JG1, s["table"])
    arr0 = jst.gather_level0(ttab, s["jplan"].sorted_vals, 3)
    ax, ay = arr0[:W][:, ca], arr0[W:2 * W][:, ca]
    bx, by = arr0[:W][:, cb], arr0[W:2 * W][:, cb]
    added = jax.jit(JG1.add_affine_lazy)((ax, ay), (bx, by))
    promoted = JG1.from_affine((ax, ay))
    return jcurve.select(jnp.asarray(single), promoted, added), t1


def jax_level2(s, lvl1):
    ph = s["ph"]
    c1, s1 = smvp_tree.chain_counts(ph.lens, 1)
    c2, s2 = smvp_tree.chain_counts(ph.lens, 2)
    t2 = int(s2[-1] + c2[-1])
    caps = smvp_tree.level_caps(s["kn"], ph.lens.shape[0], 2)
    map2 = smvp_tree.build_level_map(s1, c1, s2, c2, caps[1])
    ca, cb, single = decode(map2, t2)
    pa, pb = take(lvl1, ca), take(lvl1, cb)
    added = jax.jit(JG1.add_lazy)(pa, pb)
    return jcurve.select(jnp.asarray(single), pa, added), map2, t2


@pytest.fixture(scope="module")
def levels(stage):
    """JAX levels 1 and 2 (lazy) with the port's level-2 map."""
    lvl1, t1 = jax_level1(stage)
    lvl2, map2, t2 = jax_level2(stage, lvl1)
    return dict(lvl1=lvl1, t1=t1, lvl2=lvl2, map2=map2, t2=t2)


def test_tree_table_matches_jax(stage):
    ptab = carry(np.asarray(stage["table"]).reshape(2 * W, N))
    got = smvp_stream.build_signed_table(ptab)
    jt = np.asarray(jst.build_tree_table(JG1, stage["table"]))[:2 * N, :2 * W].T
    assert torch.equal(got, carry(jt))


@pytest.mark.parametrize("last", [False, True])
def test_tree_level_aff_matches_jax(stage, levels, last):
    lvl1, t1 = levels["lvl1"], levels["t1"]
    want = mod_p(carry(jax.jit(JG1.canon)(lvl1)))
    ptab = smvp_stream.build_signed_table(
        carry(np.asarray(stage["table"]).reshape(2 * W, N)))
    got = smvp_tree.run_tree_level(ptab, stage["ph"].level_map1, "aff", last,
                                   stage["pplan"].sorted_vals)
    assert got.shape == (39, stage["ph"].level_map1.shape[0])
    assert (mod_p(got[:, :t1]) == want).all()
    if last:
        assert (np.array(F.plane_to_ints(got[:13])) < P).all()
    # slots past the real node count hold the identity
    tail = F.plane_to_ints(got[26:, t1:])
    assert all(v == 0 for v in tail)


@pytest.mark.parametrize("last", [False, True])
def test_tree_level_full_matches_jax(levels, last):
    lvl2, t2 = levels["lvl2"], levels["t2"]
    want = mod_p(carry(jax.jit(JG1.canon)(lvl2)))
    got = smvp_tree.run_tree_level(carry(levels["lvl1"]), levels["map2"],
                                   "full", last)
    assert (mod_p(got[:, :t2]) == want).all()


def test_packed_finish_and_permute_match_jax(stage, levels):
    lvl2 = levels["lvl2"]
    layout = stage["jh"].layout
    starts = np.asarray(layout.starts_rk).reshape(-1)
    lens = np.asarray(layout.lens_rk).reshape(-1)
    add = jax.jit(JG1.add_lazy)
    acc = JG1.zero((starts.shape[0],))
    for t in range(int(lens.max())):
        live = jnp.asarray(t < lens)
        node = take(lvl2, np.where(t < lens, starts + t, 0))
        acc = jcurve.select(live, add(acc, node), acc)
    jblocks = jax.jit(JG1.canon)(acc)
    blocks = smvp_stream.packed_finish(carry(lvl2), stage["ph"].layout)
    assert (mod_p(blocks) == mod_p(carry(jblocks))).all()
    order = bpr.bpr_order(NW, CHUNK, THREADS)
    jperm = jss.permute_buckets(JG1, jnp.concatenate(list(jblocks)), layout,
                                order=order)
    got = smvp_stream.permute_buckets(blocks, stage["ph"].layout, order=order)
    assert torch.equal(got, carry(jperm))


def test_bpr_matches_jax(stage):
    """reduce_buckets_prearranged on JAX-produced canonical buckets
    (random multiples of table points, with empty buckets)."""
    rng = np.random.default_rng(4)
    threads = THREADS
    h = 1 << (CHUNK - 1)
    jtab = stage["table"]
    idx = rng.integers(0, N, size=NW * h)
    pts = JG1.from_affine((jnp.take(jtab[0], idx, axis=1),
                           jnp.take(jtab[1], idx, axis=1)))
    pts = jax.jit(lambda p: JG1.canon(JG1.double_lazy(p)))(pts)
    empty = jnp.asarray(rng.random(NW * h) < 0.2)
    pts = jcurve.select(empty, JG1.zero((NW * h,)), pts)
    order = bpr.bpr_order(NW, CHUNK, threads)
    jb = take(pts, order.reshape(-1))
    want = jbpr.reduce_buckets_prearranged(JG1, jb, NW, CHUNK, threads)
    got = bpr.reduce_buckets_prearranged(carry(jb), NW, CHUNK, threads)
    assert got.shape == (39, NW)
    assert torch.equal(got, carry(want))
