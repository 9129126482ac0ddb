"""Port CUDA kernels against their plain PyTorch versions, on the card.

Every kernel entry point (csrc/convert.cu, tree.cu, packed.cu, bpr.cu,
stream.cu, legacy.cu, canon.cu, fused.cu, each built for G1 and for
Edwards) runs on CUDA tensors and must equal its plain version word for
word: both compute the same exact integers (no tolerance).  Marked ``cuda``; without
a CUDA device every test skips.  On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import random

import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu_torch import params as PP
from webgpu_msm_bls12_377_tpu_torch.models import (
    CuzkMsmEngine,
    NaiveMsmEngine,
    PippengerMsmEngine,
)
from webgpu_msm_bls12_377_tpu_torch.ops import buckets as B
from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_tree as T
from webgpu_msm_bls12_377_tpu_torch.ops.buckets import build_bucket_plan
from webgpu_msm_bls12_377_tpu_torch.ops.convert import ints_to_words
from webgpu_msm_bls12_377_tpu_torch.ops.decompose import (
    decompose_scalars_signed,
    num_windows_for,
)
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import EDWARDS, G1, naive_msm

pytestmark = pytest.mark.cuda
P = F.P
LANES = 1000  # not a multiple of the block size: the ragged edge is masked


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def rand_plane(rng, rows, n, bound, dev, nw=F.NW):
    return torch.cat([F.ints_to_plane([rng.randrange(bound) for _ in range(n)],
                                      nw=nw)
                      for _ in range(rows // nw)]).to(dev)


#: the kernels both curves build run once per curve: ids [..] for G1 (as
#: before the Edwards builds), [ed..] for Edwards
GROUPS = pytest.mark.parametrize("group", [C.G1, C.EDWARDS], ids=["", "ed"])


def lazy_bound(group) -> int:
    """Lazy coordinates the formulas take: below 4p (G1) or 2p (Edwards)."""
    return 4 if group is C.G1 else 2


def same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)


MMC_CASES = [(group, y) for group in (C.G1, C.EDWARDS) for y in ("entry", "exit")]


@pytest.mark.parametrize("group,y", MMC_CASES, ids=[
    f"{'ed-' if group is C.EDWARDS else ''}{y}" for group, y in MMC_CASES])
def test_mont_mul_const(dev, group, y):
    ctx = group.ctx
    yv = ctx.params.r2 if y == "entry" else 1
    rng = random.Random("k1" + ctx.tag)
    a = rand_plane(rng, 2 * ctx.nw, LANES, 1 << (32 * ctx.nw), dev, ctx.nw)
    K.reset_launches()
    same(K.mont_mul_const(a, yv, ctx), K.mont_mul_const_plain(a, yv, ctx))
    assert K.launches["mont_mul_const" + ctx.tag] == 1


@GROUPS
def test_bpr_family(dev, group):
    """On lazy operands; each entry point launches the curve's build and
    not the other's."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = random.Random("k4" + tag)
    m, g, b = (rand_plane(rng, group.rows, LANES, lazy_bound(group) * ctx.p,
                          dev, ctx.nw) for _ in range(3))
    steps = torch.cat([m, g, b, m], dim=1)  # bpt 4
    m8, g8 = m[:, :LANES // 8 * 8].contiguous(), g[:, :LANES // 8 * 8].contiguous()
    K.reset_launches()
    same(K.bpr_stage1(steps, 4, 2, group), K.bpr_stage1_plain(steps, 4, 2, group))
    same(K.bpr_stage2(m8, g8, 8, 4, group),
         K.bpr_stage2_plain(m8, g8, 8, 4, group))
    same(K.bpr_fold(g8, 125, 8, group), K.bpr_fold_plain(g8, 125, 8, group))
    same(K.bpr_add(m, b, group), K.add_plain(m, b, group))
    names = ("bpr_stage1", "bpr_stage2", "bpr_fold", "bpr_add")
    assert all(K.launches[k + tag] == 1 for k in names)
    other = "_ed" if group is C.G1 else ""
    assert not any(K.launches[k + other] for k in names)


STAGE2_SHAPES = [(t, w, bpt) for t in (1, 8, 128, 512, 1024) for w in (1, 3, 17)
                 for bpt in (1, 64)]


@GROUPS
@pytest.mark.parametrize("t_count,windows,bpt", STAGE2_SHAPES)
def test_bpr_stage2_and_fold_against_plain(dev, group, t_count, windows, bpt):
    """Stage 2 (a thread a lane) and the fold (a block a window from T =
    128, several windows a block below; a thread's register levels from T
    = 256) against their plain forms on lazy operands, one launch each."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = random.Random(f"k4s2{tag}{t_count}{windows}{bpt}")
    m, g = (rand_plane(rng, group.rows, t_count * windows,
                       lazy_bound(group) * ctx.p, dev, ctx.nw) for _ in range(2))
    K.reset_launches()
    g2 = K.bpr_stage2(m, g, t_count, bpt, group)
    same(g2, K.bpr_stage2_plain(m, g, t_count, bpt, group))
    same(K.bpr_fold(g2, windows, t_count, group),
         K.bpr_fold_plain(g2, windows, t_count, group))
    assert K.launches["bpr_stage2" + tag] == K.launches["bpr_fold" + tag] == 1


@GROUPS
@pytest.mark.parametrize("chunk,threads", [(4, 8), (4, 4), (9, 8), (9, 256)])
def test_bpr_reduction_launches_at_most_three_kernels(dev, group, chunk,
                                                      threads):
    """One reduce_buckets_prearranged: stage 1 where bpt > 1, then stage 2
    and the fold, one launch each, and no other kernel."""
    from webgpu_msm_bls12_377_tpu_torch.ops import bpr

    ctx, tag = group.ctx, group.ctx.tag
    windows = num_windows_for(chunk)
    h = 1 << (chunk - 1)
    bpt = h // min(threads, h)
    rng = random.Random(f"k4red{tag}{chunk}{threads}")
    buckets = rand_plane(rng, group.rows, windows * h, ctx.p, dev, ctx.nw)
    K.reset_launches()
    got = bpr.reduce_buckets_prearranged(buckets, windows, chunk, threads, group)
    torch.cuda.synchronize()
    assert dict(K.launches) == {
        **({"bpr_stage1" + tag: 1} if bpt > 1 else {}),
        "bpr_stage2" + tag: 1, "bpr_fold" + tag: 1}
    same(got, bpr.reduce_buckets_prearranged(buckets.cpu(), windows, chunk,
                                             threads, group).to(dev))


PREP_CASES = [(group, major, form) for group in (C.G1, C.EDWARDS)
              for major in ("word", "point") for form in ("signed", "plane")]


@pytest.mark.parametrize("group,major,form", PREP_CASES, ids=[
    f"{'ed-' if g is C.EDWARDS else ''}{m}-{f}" for g, m, f in PREP_CASES])
def test_point_prep_against_plain(dev, group, major, form):
    """Kernel 1's entry, one launch from wire words in either layout to
    the signed table or the Montgomery table (Edwards with t = x*y), bit
    for bit: random coordinates below R (wire words take any value), 0,
    1, p - 1 and p among them (-0 stays 0)."""
    from webgpu_msm_bls12_377_tpu_torch.ops.convert import WireLayout

    ctx = group.ctx
    k, p = ctx.nw - 1, ctx.p
    rng = random.Random(f"prep{ctx.tag}{major}{form}")
    vals = [[rng.randrange(1 << (32 * k)) for _ in range(LANES)]
            for _ in range(2)]
    for i, v in enumerate((0, 1, p - 1, p, 0, p - 1)):
        vals[i % 2][5 * i] = v
    pm = np.array([[(v >> (32 * w)) & 0xFFFFFFFF for c in range(2)
                    for w in range(k) for v in (vals[c][j],)]
                   for j in range(LANES)], dtype=np.uint32)
    words = pm if major == "point" else np.ascontiguousarray(
        pm.reshape(LANES, 2, k).transpose(1, 2, 0))
    lay = WireLayout.of(words, major == "point", k, 2)
    t = torch.from_numpy(words.view(np.int32)).to(dev)
    out = K.SIGNED if form == "signed" else K.PLANE
    K.reset_launches()
    same(K.point_prep(t, lay, group, out), K.point_prep_plain(t, lay, group,
                                                              out))
    assert dict(K.launches) == {"point_prep" + ctx.tag: 1}


@pytest.mark.parametrize("shape", [(2, 12, 50000), (50000, 24), (8, 1 << 20),
                                   (1 << 20, 8), (2, 8, 7)])
def test_staged_copy_on_the_card(dev, shape):
    """words_to_device through pinned memory equals a plain copy, in
    either layout: in one piece (below four chunks' bytes) and in eight
    chunks of one word plane or of many points each."""
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import words_to_device

    words = np.random.default_rng(sum(shape)).integers(
        0, 1 << 32, size=shape, dtype=np.uint32)
    got = words_to_device(words, dev)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), torch.from_numpy(words.view(np.int32)))


@GROUPS
def test_tree_levels_and_finish(dev, group):
    """Tree levels 1 and 2 (kernel 2), the packed finish (3) and the
    stream kernel (5) on one small real plan."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = random.Random("k23" + tag)
    npts, chunk = 512, 8
    windows = num_windows_for(chunk)
    table = S.build_signed_table(rand_plane(rng, group.aff_rows, npts, ctx.p,
                                            dev, ctx.nw), group)
    sw = torch.tensor([[rng.randrange(1 << 32) for _ in range(npts)]
                       for _ in range(8)], dtype=torch.int64)
    sw[7] &= (1 << 29) - 1
    plan = build_bucket_plan(decompose_scalars_signed(sw.to(dev), chunk, windows),
                             chunk)
    kn = plan.sorted_vals.shape[0]
    hp = T.build_hybrid_plan(plan.starts, plan.lens, kn, 2, windows)
    K.reset_launches()
    for last in (False, True):
        same(T.run_tree_level(table, hp.level_map1, "aff", last, plan.sorted_vals,
                              group),
             T.tree_level_plain(table, hp.level_map1, "aff", last,
                                plan.sorted_vals, group))
    lvl1 = T.run_tree_level(table, hp.level_map1, "aff",
                            sorted_vals=plan.sorted_vals, group=group)
    c1, s1 = T.chain_counts(hp.lens, 1)
    c2, s2 = T.chain_counts(hp.lens, 2)
    cap2 = T.level_caps(kn, hp.lens.shape[0], 2)[1]
    map2 = T.build_level_map(s1, c1, s2, c2, cap2)
    for last in (False, True):
        same(T.run_tree_level(lvl1, map2, "full", last, group=group),
             T.tree_level_plain(lvl1, map2, "full", last, group=group))
    same(T.run_tree_level(lvl1, map2, "full", group=group, rows=True),
         T.tree_level_plain(lvl1, map2, "full", False, group=group, rows=True))
    lvl2 = T.run_tree_level(lvl1, map2, "full", group=group, rows=True)
    same(S.packed_finish(lvl2, hp.layout, group),
         S.packed_finish_plain(lvl2, hp.layout.starts_rk, hp.layout.lens_rk,
                               group))
    layout = S.build_stream_layout(plan.starts, plan.lens, windows)
    same(S.accumulate_buckets_streamed(table, plan.sorted_vals, layout, group),
         S.accumulate_buckets_streamed_plain(table, plan.sorted_vals,
                                             layout.starts_rk, layout.lens_rk,
                                             group))
    assert all(K.launches[k + tag] > 0 for k in
               ("tree_level_aff", "tree_level_full", "packed_finish",
                "stream_buckets"))


@GROUPS
@pytest.mark.parametrize("t_out", [1000, 3 * 132 * 4 * 128 + 77],
                         ids=["small", "large"])
def test_tree_level_aff_random_map(dev, group, t_out):
    """Level 1 (row loads from the row-major signed table) against the
    plain form on a random level map (pairs, singles and invalid slots)
    over a random sorted stream: fewer nodes than one block a SM, and
    more than the card holds at once, with a ragged last block."""
    ctx = group.ctx
    rng = np.random.default_rng(len(ctx.tag) * 1000 + t_out % 997)
    npts, entries = 4096, 2 * t_out + 8
    table = S.build_signed_table(
        rand_plane(random.Random(t_out), group.aff_rows, npts, ctx.p, dev,
                   ctx.nw), group)
    sorted_vals = torch.from_numpy(
        (rng.integers(0, npts, entries)
         | (rng.integers(0, 2, entries) << 30)).astype(np.int32)).to(dev)
    child = rng.integers(0, entries - 1, t_out)
    kind = rng.integers(0, 8, t_out)  # 0: invalid, 1: single, else a pair
    level_map = np.where(kind == 1, child | T.FLAG_SINGLE, child)
    level_map = np.where(kind == 0, T.FLAG_INVALID, level_map)
    level_map = torch.from_numpy(level_map.astype(np.int32)).to(dev)
    for last in (False, True):
        K.reset_launches()
        same(T.run_tree_level(table, level_map, "aff", last, sorted_vals,
                              group),
             T.tree_level_plain(table, level_map, "aff", last, sorted_vals,
                                group))
        assert K.launches["tree_level_aff" + ctx.tag] == 1


@GROUPS
@pytest.mark.parametrize("lanes", [1000, 9000], ids=["small", "large"])
def test_bpr_stage1_against_plain(dev, group, lanes):
    """BPR stage 1 in one launch against its plain form on lazy operands,
    for every split at bpt 1, 2, 8 and 64 (bpt < split runs no case: the
    wrapper refuses it): below one block a SM and, at 9,000 lanes split 4
    or 8, more threads than the card holds at once; a ragged last block."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = random.Random(f"k-stage1{tag}{lanes}")
    bound = lazy_bound(group) * ctx.p
    cols = rand_plane(rng, group.rows, 64, bound, dev, ctx.nw)
    K.reset_launches()
    runs = 0
    for bpt in (1, 2, 8, 64):
        # columns drawn from a pool of random lazy points: every step of
        # every lane a point below the lazy bound
        idx = torch.randint(0, 64, (bpt * lanes,),
                            generator=torch.Generator().manual_seed(bpt))
        steps = cols[:, idx.to(dev)].contiguous()
        for split in (1, 2, 4, 8):
            if split > bpt:
                with pytest.raises(ValueError):
                    K.bpr_stage1(steps, bpt, split, group)
                continue
            same(K.bpr_stage1(steps, bpt, split, group),
                 K.bpr_stage1_plain(steps, bpt, split, group))
            runs += 1
    assert K.launches["bpr_stage1" + tag] == runs


@GROUPS
@pytest.mark.parametrize("t_out", [1000, 3 * 132 * 2 * 128 + 77],
                         ids=["small", "large"])
def test_node_rows_and_finish_random(dev, group, t_out):
    """Tree levels writing node rows (aff and full) against their plain
    forms, then the finish on those rows over random layouts in sorted
    and in natural (window-major) order: empty buckets,
    one bucket of 130 nodes (longer than a block), fewer buckets than a
    block a SM and more than the card holds at once."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = np.random.default_rng(len(tag) * 1000 + t_out % 997)
    pool = rand_plane(random.Random(t_out), group.rows, 4096,
                      lazy_bound(group) * ctx.p, dev, ctx.nw)
    cols = torch.as_tensor(rng.integers(0, 4096, 2 * t_out + 8), device=dev)
    plane = pool[:, cols].contiguous()
    pick = rng.integers(0, 2 * t_out + 8, size=t_out)
    flags = rng.random(t_out)
    level_map = np.where(flags < 0.1, T.FLAG_INVALID,
                         np.where(flags < 0.3, pick | T.FLAG_SINGLE,
                                  np.minimum(pick, 2 * t_out + 6)))
    level_map = torch.as_tensor(level_map.astype(np.int32), device=dev)
    K.reset_launches()
    rows = T.run_tree_level(plane, level_map, "full", group=group, rows=True)
    same(rows, T.tree_level_plain(plane, level_map, "full", False, group=group,
                                  rows=True))
    assert rows.shape == (t_out, S.node_words(group))
    nb = t_out // 6
    lens = rng.integers(0, 12, size=nb)
    lens[rng.random(nb) < 0.2] = 0
    lens[nb // 2] = 130
    starts = rng.integers(0, t_out - lens + 1)
    for order in ("natural", "sorted"):
        perm = (np.arange(nb) if order == "natural"
                else np.argsort(-lens, kind="stable"))
        layout = S.StreamLayout(
            starts_rk=torch.as_tensor(starts[perm].astype(np.int32), device=dev),
            lens_rk=torch.as_tensor(lens[perm].astype(np.int32), device=dev),
            perm=torch.as_tensor(np.argsort(perm).astype(np.int32), device=dev))
        want = S.packed_finish_plain(rows, layout.starts_rk, layout.lens_rk,
                                     group)
        same(S.packed_finish(rows, layout, group), want)
    assert K.launches["tree_level_full" + tag] == 1
    # each finish: the piece pass and the fold of its cut bucket
    assert K.launches["packed_finish" + tag] == 2
    assert K.launches["finish_fold" + tag] == 2


@GROUPS
def test_finish_pieces_and_fold_against_plain(dev, group):
    """The finish's two launches (kernel 3 over pieces, then the fold of
    the buckets cut into two or more) against the plain form, bit for bit,
    on random lazy node rows: empty buckets, buckets of one node, of
    exactly PIECE and PIECE + 1 nodes, of 130 PIECE + 5 nodes (131
    pieces: the fold's first level, 66 nodes, is more than its shared
    memory holds) and random short ones, in length-sorted and in natural
    order.  The plan and both
    launches run under PyTorch's sync debug mode "error": nothing of the
    finish waits for the card."""
    ctx, tag = group.ctx, group.ctx.tag
    piece = S.PIECE
    rng = np.random.default_rng(21 + len(tag))
    t_rows = 135 * piece + 2400
    nodes = rand_plane(random.Random("pieces" + tag), group.rows, t_rows,
                       lazy_bound(group) * ctx.p, dev, ctx.nw)
    rows = S.node_rows(nodes, group)
    lens = rng.integers(0, 9, size=300)
    lens[:8] = (0, 1, piece, piece + 1, 130 * piece + 5, 0, piece,
                2 * piece + 1)
    # disjoint segments, as the tree's levels lay them out
    starts = np.cumsum(np.concatenate([[0], lens[:-1]]))
    assert starts[-1] + lens[-1] <= t_rows
    for perm in (np.arange(lens.size), np.argsort(-lens, kind="stable")):
        layout = S.StreamLayout(
            starts_rk=torch.as_tensor(starts[perm].astype(np.int32), device=dev),
            lens_rk=torch.as_tensor(lens[perm].astype(np.int32), device=dev),
            perm=torch.as_tensor(np.argsort(perm).astype(np.int32), device=dev))
        want = S.packed_finish_plain(rows.cpu(), layout.starts_rk.cpu(),
                                     layout.lens_rk.cpu(), group)
        K.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            plan = S.finish_plan(layout.starts_rk, layout.lens_rk, t_rows)
            got = S.packed_finish(rows, layout, group, plan)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        same(got, want.to(dev))
        assert dict(K.launches) == {"packed_finish" + tag: 1,
                                    "finish_fold" + tag: 1}
        assert int(plan.n_split) == 3
        assert sorted(plan.split[0, :3].tolist()) == [2, 3, 131]


@GROUPS
def test_split_fold_lone_and_block_slots_against_plain(dev, group):
    """The finish's fold with most slots of 2-3 pieces (the uniform 2^24
    shape, scaled down), more of them than the fold's grid has threads, so
    that a thread folds several; slots of 4 to FOLD_LONE pieces, folded
    on one thread, and of FOLD_LONE + 1 and 131, folded by a block, mixed
    among them with short slots before and after; one-piece and empty
    buckets.  Against the plain form bit for bit, the plan and both
    launches under sync debug mode "error"; msm.fold_lone counts the slots
    of 2 to FOLD_LONE pieces.  The buckets share their node rows: each
    reads one of a few disjoint segments, whose plain sums are the
    expected sums of every bucket that reads it."""
    from torch.profiler import ProfilerActivity, profile
    from webgpu_msm_bls12_377_tpu_torch.utils import trace

    ctx, tag = group.ctx, group.ctx.tag
    piece, lone = S.PIECE, S.FOLD_LONE
    rng = np.random.default_rng(23 + len(tag))
    seg_lens = np.concatenate([
        rng.integers(piece + 1, 3 * piece + 1, size=24),
        [piece * k for k in range(4, lone + 1)],
        [lone * piece + 1, 130 * piece + 5, 1, piece, 0]])
    seg_starts = np.cumsum(np.concatenate([[0], seg_lens[:-1]]))
    t_seg = int(seg_lens.sum())
    nodes = rand_plane(random.Random("lone" + tag), group.rows, t_seg,
                       lazy_bound(group) * ctx.p, dev, ctx.nw)
    rows = S.node_rows(nodes, group)
    seg_pieces = np.maximum(1, -(-seg_lens // piece))
    short = np.flatnonzero(seg_pieces <= 3)
    longer = np.flatnonzero(seg_pieces > 3)
    nb = 170_000
    pick = rng.choice(short, size=nb)
    # the longer segments at spread positions, short slots all around them
    at = rng.choice(np.arange(1000, nb - 1000), size=6 * longer.size,
                    replace=False)
    pick[at] = np.repeat(longer, 6)
    lens = seg_lens[pick]
    assert seg_pieces[pick].max() == 131
    want_seg = S.packed_finish_plain(
        rows.cpu(), torch.as_tensor(seg_starts.astype(np.int32)),
        torch.as_tensor(seg_lens.astype(np.int32)), group)
    want = want_seg[:, torch.as_tensor(pick)].to(dev)
    layout = S.StreamLayout(
        starts_rk=torch.as_tensor(seg_starts[pick].astype(np.int32), device=dev),
        lens_rk=torch.as_tensor(lens.astype(np.int32), device=dev),
        perm=torch.arange(nb, dtype=torch.int32, device=dev))
    pieces = seg_pieces[pick]
    cut = int((pieces > 1).sum())
    # more than the fold's threads: tree.cu's FOLD_SPLIT_GRID blocks of 64
    assert cut > 2048 * 64
    trace.reset()
    K.reset_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            plan = S.finish_plan(layout.starts_rk, layout.lens_rk,
                                 int(lens.sum()))
            got = S.packed_finish(rows, layout, group, plan)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    same(got, want)
    assert dict(K.launches) == {"packed_finish" + tag: 1,
                                "finish_fold" + tag: 1}
    counted = trace.counters()
    trace.reset()
    assert counted["msm.finish_split"] == (cut, 1)
    assert counted["msm.fold_lone"] == (
        int(((pieces > 1) & (pieces <= lone)).sum()), 1)


def extreme_values(ctx):
    """R - 1, runs of all-ones words, all-ones words but one, alternating
    words, 0, 1, p - 1, p, R - p and k p - 1 for the formulas' bounds k."""
    nw, p = ctx.nw, ctx.p
    r, ones = 1 << (32 * nw), (1 << 32) - 1
    vals = [r - 1, 0, 1, p - 1, p, r - p]
    vals += [(1 << (32 * k)) - 1 for k in range(1, nw)]
    vals += [(r - 1) ^ (ones << (32 * k)) for k in range(nw)]
    vals += [sum(ones << (32 * k) for k in range(s, nw, 2)) for s in (0, 1)]
    return vals + [k * p - 1 for k in (2, 4, 6, 8, 12, 14, 16, 18, 20)]


@GROUPS
def test_carry_chain_product_at_extreme_operands(dev, group):
    """tree.cu's mont_mul and mont_mul_pair (the carry-chain schedule, on
    their own through msm_field_mul_lanes) against ops/field.py, word for
    word: every pair of extreme operands (the pair's second product on the
    reversed pairs), and random operands below R."""
    ctx = group.ctx
    ext = extreme_values(ctx)
    rng = random.Random("chain" + ctx.tag)
    r = 1 << (32 * ctx.nw)
    cols = [[x for x in ext for _ in ext], [y for _ in ext for y in ext]]
    cols += [cols[1][::-1], cols[0][::-1]]
    ops = [F.ints_to_plane(c + [rng.randrange(r) for _ in range(LANES)],
                           nw=ctx.nw).to(dev) for c in cols]
    K.reset_launches()
    want = K.field_mul_lanes_plain(*[o.cpu() for o in ops], ctx)
    same(K.field_mul_lanes(*ops, ctx), tuple(w.to(dev) for w in want))
    assert K.launches["field_mul_lanes" + ctx.tag] == 1


@GROUPS
def test_fold_pieces_against_plain(dev, group):
    """The one-launch fold against its plain form (kernel 2's full levels)
    on hand-made buckets of random canonical nodes: empty, one piece, odd
    counts, counts about the block's 64 threads and about its 64 shared
    nodes a level, and long buckets (2,048 pieces: a duplicate-heavy
    bucket at 2^16) whose first levels live in the scratch plane; the
    inputs are left as they were."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = random.Random("fold" + tag)
    counts = [0, 1, 2, 3, 5, 63, 64, 65, 127, 128, 129, 130, 257, 0, 1000,
              2048, 7] + [rng.randrange(9) for _ in range(LANES)]
    cols = sum(counts)
    sums = rand_plane(rng, group.rows, cols, ctx.p, dev, ctx.nw)
    keep = sums.clone()
    c = torch.tensor(counts, dtype=torch.int64)
    offsets = torch.cumsum(c, 0) - c
    caps = T.level_caps(cols, len(counts), SK.fold_levels(max(counts), 1))
    K.reset_launches()
    got, s_fin = SK.fold_pieces(sums, c.to(dev), offsets.to(dev), caps, group)
    want, want_s = SK.fold_pieces_plain(sums.cpu(), c, offsets, caps, group)
    same(got, want.to(dev))
    assert torch.equal(s_fin.cpu(), want_s)
    assert torch.equal(sums, keep)
    assert K.launches["fold_pieces" + tag] == 1 and len(K.launches) == 1


@GROUPS
@pytest.mark.parametrize("t_out", [1000, 3 * 132 * 4 * 128 + 77],
                         ids=["small", "large"])
def test_tree_level_full_random_map(dev, group, t_out):
    """Row 3 (a full level, plane out, lazy and canonical) against its
    plain form on a random level map (pairs, singles and invalid slots)
    over random lazy nodes: fewer nodes than one block a SM, and more than
    the card holds at once at any register budget, a ragged last block."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = np.random.default_rng(7 + len(tag) * 1000 + t_out % 997)
    pool = rand_plane(random.Random(t_out + 3), group.rows, 4096,
                      lazy_bound(group) * ctx.p, dev, ctx.nw)
    plane = pool[:, torch.as_tensor(rng.integers(0, 4096, 2 * t_out + 8),
                                    device=dev)].contiguous()
    child = rng.integers(0, 2 * t_out + 7, t_out)
    kind = rng.integers(0, 8, t_out)  # 0: invalid, 1: single, else a pair
    level_map = np.where(kind == 1, child | T.FLAG_SINGLE, child)
    level_map = np.where(kind == 0, T.FLAG_INVALID, level_map)
    level_map = torch.from_numpy(level_map.astype(np.int32)).to(dev)
    K.reset_launches()
    for last in (False, True):
        same(T.run_tree_level(plane, level_map, "full", last, group=group),
             T.tree_level_plain(plane, level_map, "full", last, group=group))
    assert K.launches["tree_level_full" + tag] == 2


@GROUPS
@pytest.mark.parametrize("nb", [1000, 3 * 132 * 4 * 128 + 77],
                         ids=["small", "large"])
def test_stream_kernel_random_layout(dev, group, nb):
    """Row 9 against its plain form on a random layout over a random
    sorted stream: empty buckets, buckets of 1 to 20 entries in
    length-sorted order, one of 300, fewer buckets than one block a SM and
    more than the card holds at once, a ragged last block."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = np.random.default_rng(11 + len(tag) * 1000 + nb % 997)
    npts = 4096
    table = S.build_signed_table(
        rand_plane(random.Random(nb), group.aff_rows, npts, ctx.p, dev,
                   ctx.nw), group)
    lens = rng.integers(1, 21, nb)
    lens[rng.random(nb) < 0.1] = 0
    lens[nb // 3] = 300
    lens = -np.sort(-lens, kind="stable")
    entries = int(lens.sum()) + 8
    sorted_vals = torch.from_numpy(
        (rng.integers(0, npts, entries)
         | (rng.integers(0, 2, entries) << 30)).astype(np.int32)).to(dev)
    starts = rng.integers(0, entries - lens + 1)
    layout = S.StreamLayout(
        starts_rk=torch.as_tensor(starts.astype(np.int32), device=dev),
        lens_rk=torch.as_tensor(lens.astype(np.int32), device=dev),
        perm=torch.arange(nb, dtype=torch.int32, device=dev))
    K.reset_launches()
    same(S.accumulate_buckets_streamed(table, sorted_vals, layout, group),
         S.accumulate_buckets_streamed_plain(table, sorted_vals,
                                             layout.starts_rk, layout.lens_rk,
                                             group))
    assert K.launches["stream_buckets" + tag] == 1


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


@GROUPS
def test_fused_buckets_random_and_real_plan(dev, group):
    """The fused path's two passes against their plain forms, bit for bit:
    kernel 8 (fused_segments) on random rows with hand-made segments
    (empty, length 1, long, overlapping); the fold (tree.cu's
    msm_fold_pieces, one launch); and both together (accumulate_buckets_fused on the card
    against the same function on the CPU, the plain forms) with buckets of
    0, 1, PIECE, PIECE + 1 and many times PIECE rows, and on a real plan,
    single dispatch and windowed."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = random.Random("k8" + tag)
    piece = SK.PIECE
    # buckets tiling the first rows in order, of every kind of length
    blens = [0, 1, piece, piece + 1, 0, 12 * piece + 3, 2, piece - 1,
             3 * piece]
    count = max(600, sum(blens))
    rows = torch.zeros((count, SK.ROW_WORDS), dtype=torch.int32, device=dev)
    rows[:, :group.aff_rows] = rand_plane(rng, group.aff_rows, count, ctx.p,
                                          dev, ctx.nw).T
    lens = [0, 1, 2, 65, 0, 33, 1, 100] + [rng.randrange(0, 9) for _ in range(LANES - 8)]
    starts = [rng.randrange(0, count - l + 1) for l in lens]
    starts, lens = (torch.tensor(v, dtype=torch.int32, device=dev)
                    for v in (starts, lens))
    K.reset_launches()
    same(SK.fused_segments(rows, starts, lens, group),
         SK.accumulate_buckets_fused_plain(rows, starts, lens, group))
    assert K.launches["fused_buckets" + tag] == 1 and len(K.launches) == 1
    # the kernel reads raw int32 pointers: other operands are refused
    for bad in ((rows, starts.to(torch.int64), lens),
                (rows, starts, lens.repeat_interleave(2)[::2]),
                (rows.T.contiguous().T, starts, lens)):
        for fn in (SK.fused_segments, SK.accumulate_buckets_fused):
            with pytest.raises(ValueError, match="contiguous int32"):
                fn(*bad, group)
    assert K.launches["fused_buckets" + tag] == 1

    # both passes on the buckets above
    bstarts = np.cumsum([0] + blens[:-1])
    bstarts, blens = (torch.tensor(v, dtype=torch.int32) for v in (bstarts, blens))
    cpu_rows = rows.cpu()
    plan = SK.piece_plan(bstarts.to(dev), blens.to(dev), count, count)
    sums = SK.fused_segments(rows, plan.starts, plan.lens, group)
    same(sums, SK.accumulate_buckets_fused_plain(rows, plan.starts, plan.lens,
                                                 group))
    K.reset_launches()
    got, s_fin = SK.fold_pieces(sums, plan.counts, plan.offsets, plan.caps,
                                group)
    cpu_plan = SK.piece_plan(bstarts, blens, count, count)
    want, want_s = SK.fold_pieces(sums.cpu(), cpu_plan.counts,
                                  cpu_plan.offsets, cpu_plan.caps, group)
    same(got, want.to(dev))
    assert torch.equal(s_fin.cpu(), want_s)
    # one launch of the fold, however many levels the plain form runs
    assert K.launches["fold_pieces" + tag] == 1 and len(plan.caps) > 0
    assert K.launches["tree_level_full" + tag] == 0
    order = torch.randperm(len(blens), generator=torch.Generator().manual_seed(8))
    same(SK.accumulate_buckets_fused(rows, bstarts.to(dev), blens.to(dev), group,
                                     order=order.to(dev)),
         SK.accumulate_buckets_fused(cpu_rows, bstarts, blens, group,
                                     order=order).to(dev))

    npts, chunk = 300, 9
    windows = num_windows_for(chunk)
    wide = SK.make_wide_rows(
        rand_plane(rng, group.aff_rows, npts, ctx.p, dev, ctx.nw), group)
    sw = torch.tensor([[rng.randrange(1 << 32) for _ in range(npts)]
                       for _ in range(8)], dtype=torch.int64)
    sw[7] &= (1 << 29) - 1
    plan = build_bucket_plan(decompose_scalars_signed(sw.to(dev), chunk, windows),
                             chunk)
    gathered = SK.pregather_signed(wide, plan.sorted_vals, group)
    want = SK.accumulate_buckets_fused(gathered.cpu(), plan.starts.cpu(),
                                       plan.lens.cpu(), group, max_len=npts)
    same(SK.accumulate_buckets_fused(gathered, plan.starts, plan.lens, group,
                                     max_len=npts), want.to(dev))
    K.reset_launches()
    same(SK.accumulate_buckets_windowed(wide, plan.sorted_vals, plan.starts,
                                        plan.lens, windows, group), want.to(dev))
    assert K.launches["fused_buckets" + tag] == windows


def edge_lanes(group, a, b):
    """b with lane 0 the identity, lane 1 equal to a's and lane 2 a's
    inverse (canonical), the operands a complete add must take."""
    b = b.clone()
    b[:, 0] = C.merge(group.zero(1, a.device))[:, 0]
    b[:, 1] = a[:, 1]
    b[:, 2] = C.merge(group.neg(group.split(a[:, 2:3])))[:, 0]
    return b


@GROUPS
def test_canonical_family_and_masked_add_mixed(dev, group):
    """The tree sum and the running sum on random lanes (identity, equal
    and inverse operands among them), and kernel 6 and the scalar
    multiplication, which replace the one-step masked mixed add and
    double-and-add, on random lanes too: one launch each."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = random.Random("k67" + tag)
    a, g, b = (rand_plane(rng, group.rows, LANES, ctx.p, dev, ctx.nw)
               for _ in range(3))
    g, b = edge_lanes(group, a, g), edge_lanes(group, a, b)
    aff = rand_plane(rng, group.aff_rows, LANES, ctx.p, dev, ctx.nw)
    table = K.build_signed_table(aff, group)
    vals = torch.tensor([rng.randrange(LANES) | (rng.randrange(2) << 30)
                         for _ in range(LANES)], dtype=torch.int32, device=dev)
    starts = torch.arange(LANES, dtype=torch.int32, device=dev)
    lens = torch.ones(LANES, dtype=torch.int32, device=dev)
    sw = torch.randint(-(1 << 31), 1 << 31, (8, LANES), dtype=torch.int32,
                       generator=torch.Generator().manual_seed(3)).to(dev)
    K.reset_launches()
    same(B.legacy_buckets(table, vals, starts, lens, group),
         B.legacy_buckets_plain(table, vals, starts, lens, group))
    pts = torch.cat([a[:, :512], b[:, :512]], dim=1)
    same(K.tree_sum(pts, group), K.tree_sum_plain(pts, group))
    same(K.scalar_mult(aff, sw, 2, group), K.scalar_mult_plain(aff, sw, 2, group))
    same(K.fused_running_add(a, g, b, group),
         K.fused_running_add_plain(a, g, b, group))
    assert dict(K.launches) == {
        k + tag: 1 for k in ("legacy_buckets", "tree_sum", "scalar_mult",
                             "running_sum")}
    # one level of the tree has no kernel of its own
    with pytest.raises(ValueError, match="no kernel"):
        K.fused_add(a, b, group)


def tree_planes(group, x):
    """Planes of 2 * x's width for the tree sum: x then edge_lanes of it
    (the first level meets the identity, an equal and an inverse lane);
    x twice (every first-level add a doubling); x then its negation (the
    first level all identities)."""
    neg = C.merge(group.neg(group.split(x)))
    return [torch.cat([x, edge_lanes(group, x, x.flip(1))], dim=1),
            torch.cat([x, x], dim=1), torch.cat([x, neg], dim=1)]


@GROUPS
@pytest.mark.parametrize("width", [1, 2, 256, 512, 4096, 1 << 16, 1 << 18])
def test_tree_sum_on_the_card(dev, group, width):
    """msm_tree_sum against its plain form (log2 N levels of the canonical
    add), bit for bit, from one block (up to 256 lanes) to 256 blocks
    (2^16, the naive call's width) with the last block's finish, and at
    2^18, where a thread first folds four lanes on its own; each plane
    twice, so that state left behind by one launch would show in the
    next."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = random.Random(f"tree{tag}{width}")
    if width < 8:
        planes = [rand_plane(rng, group.rows, width, ctx.p, dev, ctx.nw)]
    else:
        planes = tree_planes(group, rand_plane(rng, group.rows, width // 2,
                                               ctx.p, dev, ctx.nw))
    K.reset_launches()
    for pts in planes:
        want = K.tree_sum_plain(pts, group)
        for _ in range(2):
            same(K.tree_sum(pts, group), want)
    assert dict(K.launches) == {"tree_sum" + tag: 2 * len(planes)}


@GROUPS
def test_tree_sum_on_two_streams_at_once(dev, group):
    """Two msm_tree_sum launches at 2^16 (256 blocks and the last block's
    finish), each on its own stream and both enqueued before either ends,
    three times: each call counts its blocks in its own scratch, so both
    equal the plain form."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = random.Random(f"tree2{tag}")
    planes = [rand_plane(rng, group.rows, 1 << 16, ctx.p, dev, ctx.nw)
              for _ in range(2)]
    want = [K.tree_sum_plain(pts, group) for pts in planes]
    streams = [torch.cuda.Stream(device=dev) for _ in planes]
    torch.cuda.synchronize(dev)
    K.reset_launches()
    for _ in range(3):
        got = []
        for stream, pts in zip(streams, planes):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                got.append(K.tree_sum(pts, group))
        torch.cuda.synchronize(dev)
        for g, w in zip(got, want):
            same(g, w)
    assert dict(K.launches) == {"tree_sum" + tag: 6}


@GROUPS
@pytest.mark.parametrize("steps", [1, 3, 8])
def test_running_sum_on_the_card(dev, group, steps):
    """msm_running_sum against its plain form (steps one-step plain
    forms), bit for bit, twice: m and g with identity lanes, step 0's
    addends equal to m and its inverse (edge_lanes)."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = random.Random(f"running{tag}{steps}")
    m, g = (rand_plane(rng, group.rows, LANES, ctx.p, dev, ctx.nw)
            for _ in range(2))
    zero = C.merge(group.zero(1, dev))[:, 0]
    m[:, 0], g[:, 1] = zero, zero
    walk = [edge_lanes(group, m, rand_plane(rng, group.rows, LANES, ctx.p,
                                            dev, ctx.nw))
            for _ in range(steps)]
    walk = torch.cat(walk, dim=1)
    want = K.running_sum_plain(m, g, walk, steps, group)
    K.reset_launches()
    for _ in range(2):
        same(K.running_sum(m, g, walk, steps, group), want)
    assert dict(K.launches) == {"running_sum" + tag: 2}


def scalar_words_of(ks, dev):
    return torch.from_numpy(ints_to_words(ks, 8).view(np.int32)).to(dev)


@GROUPS
@pytest.mark.parametrize("lanes", [1, 129, LANES])
def test_scalar_mult_on_the_card(dev, group, lanes):
    """msm_scalar_mult against its plain form (bits one-step plain forms),
    bit for bit: scalars 0, 1, r - 1, 2^253 - 1, 2^256 - 1 and a lone top
    bit among random ones, at bits 0, 1, 200, 253 and 256."""
    ctx = group.ctx
    rng = random.Random(f"smult{ctx.tag}{lanes}")
    order = (PP.SCALAR_FIELD if group is C.G1
             else PP.EDWARDS_SUBGROUP_CHARACTERISTIC)
    table = rand_plane(rng, group.aff_rows, lanes, ctx.p, dev, ctx.nw)
    ks = ([0, 1, order - 1, (1 << 253) - 1, (1 << 256) - 1, 1 << 255]
          + [rng.randrange(1 << 256) for _ in range(lanes)])[:lanes]
    sw = scalar_words_of(ks, dev)
    K.reset_launches()
    for bits in (0, 1, 200, 253, 256):
        same(K.scalar_mult(table, sw, bits, group),
             K.scalar_mult_plain(table, sw, bits, group))
    assert K.launches["scalar_mult" + ctx.tag] == 5


@GROUPS
def test_legacy_buckets_on_the_card(dev, group):
    """msm_legacy_buckets against its plain form (lockstep rounds of the
    masked mixed add), bit for bit: hand-made segments of a random entry
    stream (empty, length 1, 65, 300, overlapping), and a real chunk-4
    plan's buckets (empty and long among them) and its pieces."""
    ctx, tag = group.ctx, group.ctx.tag
    rng = random.Random("legacy" + tag)
    npts = 512
    aff = rand_plane(rng, group.aff_rows, npts, ctx.p, dev, ctx.nw)
    table = K.build_signed_table(aff, group)
    count = 3000
    vals = torch.tensor([rng.randrange(npts) | (rng.randrange(2) << 30)
                         for _ in range(count)], dtype=torch.int32, device=dev)
    lens = [0, 1, 2, 65, 0, 33, 1, 300] + [rng.randrange(9) for _ in range(500)]
    starts = [rng.randrange(count - ln + 1) for ln in lens]
    segs = [tuple(torch.tensor(v, dtype=torch.int32, device=dev)
                  for v in (starts, lens))]
    sw = torch.tensor(ints_to_words([rng.randrange(1 << 253)
                                     for _ in range(npts)], 8).view(np.int32))
    plan = build_bucket_plan(decompose_scalars_signed(
        sw.to(dev), 4, num_windows_for(4)), 4)
    assert int(plan.lens.min()) == 0 and int(plan.lens.max()) > SK.PIECE
    pp = SK.piece_plan(plan.starts, plan.lens, plan.sorted_vals.shape[0], npts)
    K.reset_launches()
    for v, (s, ln) in [(vals, segs[0]), (plan.sorted_vals, (plan.starts,
                                                           plan.lens)),
                       (plan.sorted_vals, (pp.starts, pp.lens))]:
        same(B.legacy_buckets(table, v, s, ln, group),
             B.legacy_buckets_plain(table, v, s, ln, group))
    assert K.launches["legacy_buckets" + tag] == 3


@pytest.fixture(scope="module")
def msm_case():
    rng = random.Random("k-e2e")
    pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 60))
           for _ in range(96)]
    scalars = [rng.randrange(0, 1 << 253) for _ in range(96)]
    return ([crv.g1_to_affine(p) for p in pts], scalars,
            crv.g1_to_affine(naive_msm(pts, scalars, G1)))


def case_of(request, group):
    """The curve's engine case: (affine points, scalars, affine MSM)."""
    return request.getfixturevalue("msm_case" if group is C.G1 else "ed_case")


@GROUPS
@pytest.mark.parametrize("mode,kernel", [("stream", "stream_buckets"),
                                         ("legacy", "legacy_buckets")])
def test_stream_and_legacy_engines_on_the_card(dev, request, group, mode,
                                               kernel):
    aff, scalars, want = case_of(request, group)
    tag = group.ctx.tag
    cls = PippengerMsmEngine if mode == "legacy" else CuzkMsmEngine
    eng = cls(group.CURVE, chunk_size=4, num_bpr_threads=4, smvp_mode=mode)
    K.reset_launches()
    got = eng.compute_msm(aff, scalars)
    assert (got["x"], got["y"]) == want
    assert K.launches[kernel + tag] == 1 and K.launches["bpr_fold" + tag] == 1
    assert all(k.endswith("_ed") == bool(tag) for k in K.launches)


@GROUPS
@pytest.mark.parametrize("chunk", [4, 9])
def test_fused_engine_on_the_card(dev, request, group, chunk):
    """The fused engine against the oracle: kernel 8 once at chunk 4, once
    per window at chunk 9, then one fold."""
    aff, scalars, want = case_of(request, group)
    tag = group.ctx.tag
    eng = CuzkMsmEngine(group.CURVE, chunk_size=chunk, num_bpr_threads=4,
                        smvp_mode="fused")
    K.reset_launches()
    got = eng.compute_msm(aff, scalars)
    assert (got["x"], got["y"]) == want
    assert K.launches["fused_buckets" + tag] == (
        1 if chunk == 4 else num_windows_for(chunk))
    # one fold, in one launch
    assert K.launches["fold_pieces" + tag] == 1
    assert K.launches["tree_level_full" + tag] == 0
    assert K.launches["legacy_buckets" + tag] == 0
    assert K.launches["stream_buckets" + tag] == 0
    assert all(k.endswith("_ed") == bool(tag) for k in K.launches)


def test_pure_tree_engine_on_the_card(dev, msm_case):
    aff, scalars, want = msm_case
    eng = CuzkMsmEngine(chunk_size=4, num_bpr_threads=4, smvp_mode="tree")
    K.reset_launches()
    got = eng.compute_msm(aff, scalars)
    assert (got["x"], got["y"]) == want
    assert K.launches["tree_level_aff"] == 1 and K.launches["tree_level_full"] > 1
    assert K.launches["packed_finish"] == 0


@pytest.mark.parametrize("mode", ["tree", "stream", "fused"])
def test_batch_on_the_card(dev, msm_case, mode, monkeypatch):
    """Three sets over one point set: one point prep for the batch and
    one Montgomery exit per set, results equal to
    compute_msm per set, and the per-set stage makes no call that waits
    for the device (PyTorch's sync debug mode raises on one)."""
    aff, scalars, want = msm_case
    rng = random.Random("k-batch")
    sets = [scalars] + [[rng.randrange(0, 1 << 253) for _ in range(96)]
                        for _ in range(2)]
    eng = CuzkMsmEngine(chunk_size=4, num_bpr_threads=4, smvp_mode=mode,
                        tree_finish=2 if mode == "tree" else None)
    singles = [eng.compute_msm(aff, s) for s in sets]  # also warms the caches
    assert (singles[0]["x"], singles[0]["y"]) == want
    real = CuzkMsmEngine._batch_sets

    def strict(self, *a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setattr(CuzkMsmEngine, "_batch_sets", strict)
    K.reset_launches()
    assert eng.compute_msm_batch(aff, sets) == singles
    assert K.launches["point_prep"] == 1
    assert K.launches["mont_mul_const"] == len(sets)


@GROUPS
def test_naive_engine_on_the_card(dev, request, group):
    aff, scalars, _ = case_of(request, group)
    aff, scalars = aff[:64], scalars[:64]
    nw, tag = group.ctx.nw, group.ctx.tag
    cw = 12 if group is C.G1 else 8
    pw = np.stack([ints_to_words([a[0] for a in aff], cw),
                   ints_to_words([a[1] for a in aff], cw)])
    K.reset_launches()
    out = NaiveMsmEngine(group.CURVE).build_fn()(pw, ints_to_words(scalars, 8))
    coords = [F.plane_to_ints(out[c * nw:(c + 1) * nw])[0]
              for c in range(out.shape[0] // nw)]
    if group is C.G1:
        got = crv.g1_to_affine(crv.ProjectivePoint(*coords))
        want = crv.g1_to_affine(naive_msm(
            [crv.g1_from_affine(*a) for a in aff], scalars, G1))
    else:
        got = crv.ed_to_affine(crv.ExtendedPoint(*coords))
        want = crv.ed_to_affine(naive_msm(
            [crv.ed_from_affine(*a) for a in aff], scalars, EDWARDS))
    assert got == want
    assert K.launches["scalar_mult" + tag] == 1
    assert K.launches["tree_sum" + tag] == 1


def test_engine_on_the_card_matches_oracle(dev):
    rng = random.Random("k-e2e")
    pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 60))
           for _ in range(96)]
    scalars = [rng.randrange(0, 1 << 253) for _ in range(96)]
    eng = CuzkMsmEngine(chunk_size=4, num_bpr_threads=4, smvp_mode="tree",
                        tree_finish=2)
    K.reset_launches()
    got = eng.compute_msm([crv.g1_to_affine(p) for p in pts], scalars)
    assert (got["x"], got["y"]) == crv.g1_to_affine(naive_msm(pts, scalars, G1))
    assert all(K.launches[k] > 0 for k in
               ("point_prep", "mont_mul_const", "tree_level_aff",
                "tree_level_full", "packed_finish", "finish_fold",
                "bpr_stage1", "bpr_stage2", "bpr_fold"))
    assert K.launches["packed_finish"] == K.launches["finish_fold"] == 1


@GROUPS
def test_hybrid_engine_cuts_a_long_bucket_on_the_card(dev, group):
    """300 of 320 points share one scalar: that bucket's 75 level-2 nodes
    a window are cut into pieces and folded on the card; the MSM equals
    the oracle, and a finish is one piece pass and one fold."""
    rng = random.Random("k-long" + group.ctx.tag)
    shared = (1 << 252) + 0x0F1E2D3C4B5A6978
    scalars = [shared] * 300 + [rng.randrange(0, 1 << 253) for _ in range(20)]
    ks = [rng.randrange(1, 1 << 60) for _ in range(320)]
    if group is C.G1:
        pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, k) for k in ks]
        aff = [crv.g1_to_affine(p) for p in pts]
        want = crv.g1_to_affine(naive_msm(pts, scalars, G1))
    else:
        pts = [crv.ed_scalar_mult(crv.ED_GENERATOR, k) for k in ks]
        aff = [crv.ed_to_affine(p) for p in pts]
        want = crv.ed_to_affine(naive_msm(pts, scalars, EDWARDS))
    eng = CuzkMsmEngine(group.CURVE, chunk_size=4, num_bpr_threads=4,
                        smvp_mode="tree", tree_finish=2)
    K.reset_launches()
    got = eng.compute_msm(aff, scalars)
    assert (got["x"], got["y"]) == want
    tag = group.ctx.tag
    assert K.launches["packed_finish" + tag] == 1
    assert K.launches["finish_fold" + tag] == 1


def test_force_recompile_rebuilds_on_the_card(dev, msm_case):
    """compute_msm(force_recompile=True) compiles every library again with
    nvcc (each one a new file under the same name, the build directory
    kept), and the call still launches its kernels and equals the
    oracle."""
    from webgpu_msm_bls12_377_tpu_torch import compute_msm

    aff, scalars, want = msm_case
    built, _ = K.build_all()
    libs = [built / f"libmsm_{name}.so" for name, _, _ in K.LIBRARIES]
    before = [lib.stat().st_ino for lib in libs]
    K.reset_launches()
    got = compute_msm(aff, scalars, force_recompile=True)
    assert (got["x"], got["y"]) == want
    assert K.launches["mont_mul_const"] > 0
    assert all(lib.stat().st_ino != ino for lib, ino in zip(libs, before))
    assert sorted(p.name for p in built.parent.iterdir()
                  if p.name.startswith(built.name)) == [built.name]


# -- Edwards engine (-DMSM_CURVE_ED builds) ------------------------------


@pytest.fixture(scope="module")
def ed_case():
    rng = random.Random("k-ed-e2e")
    pts = [crv.ed_scalar_mult(crv.ED_GENERATOR, rng.randrange(1, 1 << 60))
           for _ in range(96)]
    scalars = [rng.randrange(0, 1 << 253) for _ in range(96)]
    return ([crv.ed_to_affine(p) for p in pts], scalars,
            crv.ed_to_affine(naive_msm(pts, scalars, EDWARDS)))


@pytest.mark.parametrize("mode,finish", [("tree", 2), ("tree", None),
                                         ("stream", None)],
                         ids=["hybrid", "pure-tree", "stream"])
def test_edwards_engine_on_the_card(dev, ed_case, mode, finish):
    aff, scalars, want = ed_case
    eng = CuzkMsmEngine(CurveId.EDWARDS_BLS12, chunk_size=4, num_bpr_threads=4,
                        smvp_mode=mode, tree_finish=finish)
    K.reset_launches()
    got = eng.compute_msm(aff, scalars)
    assert (got["x"], got["y"]) == want
    assert K.launches["point_prep_ed"] == 1
    assert K.launches["mont_mul_const_ed"] == 1
    assert K.launches["bpr_fold_ed"] > 0
    assert not any(v for k, v in K.launches.items() if not k.endswith("_ed"))
    batch = eng.compute_msm_batch(aff, [scalars, scalars[::-1]])
    assert batch[0] == got
    assert batch[1] == eng.compute_msm(aff, scalars[::-1])
