"""Port CUDA kernels against their plain PyTorch versions, on the card.

Every kernel entry point (csrc/convert.cu, tree.cu, packed.cu, bpr.cu,
stream.cu, legacy.cu, canon.cu) runs on CUDA tensors and must equal its plain version word for word: both
compute the same exact integers (no tolerance).  Marked ``cuda``; without
a CUDA device every test skips.  On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import random

import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu_torch.models import (
    CuzkMsmEngine,
    NaiveMsmEngine,
    PippengerMsmEngine,
)
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_tree as T
from webgpu_msm_bls12_377_tpu_torch.ops.buckets import build_bucket_plan
from webgpu_msm_bls12_377_tpu_torch.ops.convert import ints_to_words
from webgpu_msm_bls12_377_tpu_torch.ops.decompose import (
    decompose_scalars_signed,
    num_windows_for,
)
from webgpu_msm_bls12_377_tpu_torch.params import BLS12_377_PARAMS
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import G1, naive_msm

pytestmark = pytest.mark.cuda
P = F.P
LANES = 1000  # not a multiple of the block size: the ragged edge is masked


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def rand_plane(rng, rows, n, bound, dev):
    return torch.cat([F.ints_to_plane([rng.randrange(bound) for _ in range(n)])
                      for _ in range(rows // F.NW)]).to(dev)


def same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)


@pytest.mark.parametrize("y", [BLS12_377_PARAMS.r2, 1], ids=["entry", "exit"])
def test_mont_mul_const(dev, y):
    a = rand_plane(random.Random("k1"), 26, LANES, 1 << 416, dev)
    same(K.mont_mul_const(a, y), K.mont_mul_const_plain(a, y))


def test_bpr_family(dev):
    rng = random.Random("k4")
    m, g, b = (rand_plane(rng, 39, LANES, 4 * P, dev) for _ in range(3))
    bits = torch.randint(0, 2, (LANES,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0)).to(dev)
    K.reset_launches()
    same(K.bpr_running_add(m, g, b), K.running_add_plain(m, g, b))
    same(K.bpr_double(m), K.double_plain(m))
    same(K.bpr_masked_add_double(m, g, bits), K.masked_add_double_plain(m, g, bits))
    same(K.bpr_add(m, b), K.add_plain(m, b))
    assert all(K.launches[k] == 1 for k in
               ("bpr_running_add", "bpr_double", "bpr_masked_add_double", "bpr_add"))


def test_tree_levels_and_finish(dev):
    rng = random.Random("k23")
    npts, chunk = 512, 8
    windows = num_windows_for(chunk)
    table = S.build_signed_table(rand_plane(rng, 26, npts, P, dev))
    sw = torch.tensor([[rng.randrange(1 << 32) for _ in range(npts)]
                       for _ in range(8)], dtype=torch.int64)
    sw[7] &= (1 << 29) - 1
    plan = build_bucket_plan(decompose_scalars_signed(sw.to(dev), chunk, windows),
                             chunk)
    kn = plan.sorted_vals.shape[0]
    hp = T.build_hybrid_plan(plan.starts, plan.lens, kn, 2, windows)
    for last in (False, True):
        same(T.run_tree_level(table, hp.level_map1, "aff", last, plan.sorted_vals),
             T.tree_level_plain(table, hp.level_map1, "aff", last, plan.sorted_vals))
    lvl1 = T.run_tree_level(table, hp.level_map1, "aff", sorted_vals=plan.sorted_vals)
    c1, s1 = T.chain_counts(hp.lens, 1)
    c2, s2 = T.chain_counts(hp.lens, 2)
    cap2 = T.level_caps(kn, hp.lens.shape[0], 2)[1]
    map2 = T.build_level_map(s1, c1, s2, c2, cap2)
    for last in (False, True):
        same(T.run_tree_level(lvl1, map2, "full", last),
             T.tree_level_plain(lvl1, map2, "full", last))
    lvl2 = T.run_tree_level(lvl1, map2, "full")
    same(S.packed_finish(lvl2, hp.layout),
         S.packed_finish_plain(lvl2, hp.layout.starts_rk, hp.layout.lens_rk))


    layout = S.build_stream_layout(plan.starts, plan.lens, windows)
    same(S.accumulate_buckets_streamed(table, plan.sorted_vals, layout),
         S.accumulate_buckets_streamed_plain(table, plan.sorted_vals,
                                             layout.starts_rk, layout.lens_rk))


def test_stream_duplicate_heavy_bucket(dev):
    """One bucket holds every entry of its window: a long runtime loop."""
    rng = random.Random("k5-dup")
    npts, chunk = 300, 8
    windows = num_windows_for(chunk)
    table = S.build_signed_table(rand_plane(rng, 26, npts, P, dev))
    sw = torch.tensor([[0x9ABCDEF0] * npts, [0x12345678] * npts]
                      + [[0] * npts] * 6, dtype=torch.int64)
    plan = build_bucket_plan(decompose_scalars_signed(sw.to(dev), chunk, windows),
                             chunk)
    layout = S.build_stream_layout(plan.starts, plan.lens, windows)
    assert int(layout.lens_rk.max()) == npts
    same(S.accumulate_buckets_streamed(table, plan.sorted_vals, layout),
         S.accumulate_buckets_streamed_plain(table, plan.sorted_vals,
                                             layout.starts_rk, layout.lens_rk))


def test_canonical_family_and_masked_add_mixed(dev):
    rng = random.Random("k67")
    a, g, b = (rand_plane(rng, 39, LANES, P, dev) for _ in range(3))
    aff = rand_plane(rng, 26, LANES, P, dev)
    gen = torch.Generator().manual_seed(3)
    bits, valid = (torch.randint(0, 2, (LANES,), dtype=torch.int32,
                                 generator=gen).to(dev) for _ in range(2))
    K.reset_launches()
    same(K.masked_add_mixed(a, aff, bits, valid),
         K.masked_add_mixed_plain(a, aff, bits, valid))
    same(K.fused_add(a, b), K.fused_add_plain(a, b))
    same(K.masked_add_and_double(a, g, bits),
         K.masked_add_and_double_plain(a, g, bits))
    same(K.fused_running_add(a, g, b), K.fused_running_add_plain(a, g, b))
    assert all(K.launches[k] == 1 for k in
               ("masked_add_mixed", "fused_add", "masked_add_and_double",
                "fused_running_add"))


@pytest.fixture(scope="module")
def msm_case():
    rng = random.Random("k-e2e")
    pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 60))
           for _ in range(96)]
    scalars = [rng.randrange(0, 1 << 253) for _ in range(96)]
    return ([crv.g1_to_affine(p) for p in pts], scalars,
            crv.g1_to_affine(naive_msm(pts, scalars, G1)))


@pytest.mark.parametrize("mode,kernel", [("stream", "stream_buckets"),
                                         ("legacy", "masked_add_mixed")])
def test_stream_and_legacy_engines_on_the_card(dev, msm_case, mode, kernel):
    aff, scalars, want = msm_case
    cls = PippengerMsmEngine if mode == "legacy" else CuzkMsmEngine
    eng = cls(chunk_size=4, num_bpr_threads=4, smvp_mode=mode)
    K.reset_launches()
    got = eng.compute_msm(aff, scalars)
    assert (got["x"], got["y"]) == want
    assert K.launches[kernel] > 0 and K.launches["bpr_add"] > 0


def test_naive_engine_on_the_card(dev, msm_case):
    aff, scalars, _ = msm_case
    aff, scalars = aff[:64], scalars[:64]
    pw = np.stack([ints_to_words([a[0] for a in aff], 12),
                   ints_to_words([a[1] for a in aff], 12)])
    K.reset_launches()
    out = NaiveMsmEngine().build_fn()(pw, ints_to_words(scalars, 8))
    got = crv.ProjectivePoint(*(F.plane_to_ints(out[c * 13:(c + 1) * 13])[0]
                                for c in range(3)))
    want = naive_msm([crv.g1_from_affine(*a) for a in aff], scalars, G1)
    assert crv.g1_eq(got, want)
    assert K.launches["masked_add_and_double"] == 256
    assert K.launches["fused_add"] == 6


def test_engine_on_the_card_matches_oracle(dev):
    rng = random.Random("k-e2e")
    pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 60))
           for _ in range(96)]
    scalars = [rng.randrange(0, 1 << 253) for _ in range(96)]
    eng = CuzkMsmEngine(chunk_size=4, num_bpr_threads=4, smvp_mode="tree")
    K.reset_launches()
    got = eng.compute_msm([crv.g1_to_affine(p) for p in pts], scalars)
    assert (got["x"], got["y"]) == crv.g1_to_affine(naive_msm(pts, scalars, G1))
    assert all(K.launches[k] > 0 for k in
               ("mont_mul_const", "tree_level_aff", "tree_level_full",
                "packed_finish", "bpr_running_add", "bpr_double",
                "bpr_masked_add_double", "bpr_add"))
