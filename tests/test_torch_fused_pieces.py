"""The fused path's piece split (ops/smvp_kernel.py: piece_plan,
fold_pieces, accumulate_buckets_fused) and the hybrid finish's
(ops/smvp_stream.py: finish_plan, fold_depth) on the CPU, without the JAX
package:
the plan against a plain enumeration of the pieces, built from shapes
alone (on the meta device, which holds no data to read back), the default
2^14 shape's chains no longer than PIECE, and the two passes against one
chain of adds a bucket on real curve points of both curves, with buckets
of length 0, 1, PIECE, PIECE + 1 and many times PIECE.  Exact integers
throughout: words where the order of the adds is the same, points (cross
products mod p) where it is not.
"""

import random

import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu_torch.ops import buckets, decompose
from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_tree as T
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv

torch.set_num_threads(1)

GROUPS = pytest.mark.parametrize("group", [C.G1, C.EDWARDS], ids=["", "ed"])


def pieces_of(starts, lens, piece):
    """The plan's pieces by plain enumeration: (start, length) per column."""
    out = []
    for s, n in zip(starts, lens):
        out += [(s + j, min(piece, n - j)) for j in range(0, n, piece)]
    return out


@pytest.mark.parametrize("piece", [2, 3, 16])
def test_piece_plan_matches_enumeration(piece):
    lens = [0, 1, piece, piece + 1, 0, 7 * piece + 3, 2, 0]
    starts = list(np.cumsum([0] + lens[:-1]))
    count, max_len = sum(lens) + 5, max(lens)
    plan = SK.piece_plan(torch.tensor(starts, dtype=torch.int32),
                         torch.tensor(lens, dtype=torch.int32), count, max_len,
                         piece)
    want = pieces_of(starts, lens, piece)
    cap = count // piece + len(lens)
    assert len(want) <= cap == plan.starts.shape[0] == plan.lens.shape[0]
    assert plan.starts.dtype == plan.lens.dtype == torch.int32
    got = list(zip(plan.starts.tolist(), plan.lens.tolist()))
    assert got[:len(want)] == want
    assert all(n == 0 for _, n in got[len(want):])
    counts = [-(-n // piece) for n in lens]
    assert plan.counts.tolist() == counts
    assert plan.offsets.tolist() == list(np.cumsum([0] + counts[:-1]))
    levels = SK.fold_levels(max_len, piece)
    assert levels == int(np.ceil(np.log2(max(counts))))
    assert plan.caps == T.level_caps(cap, len(lens), levels)


@pytest.mark.parametrize("piece", [2, 3, 32])
def test_finish_plan_matches_enumeration(piece):
    """The hybrid finish's pieces (ops/smvp_stream.py:finish_plan): every
    bucket at least one piece (an empty bucket an empty one), a one-piece
    bucket's output column in dst, the buckets of two or more pieces in
    the first slots of split, in column order, and nothing past the real
    pieces."""
    lens = [0, 1, piece, piece + 1, 0, 7 * piece + 3, 2, 0, 3 * piece]
    starts = list(np.cumsum([0] + lens[:-1]))
    t_rows = sum(lens) + 5
    plan = S.finish_plan(torch.tensor(starts, dtype=torch.int32),
                         torch.tensor(lens, dtype=torch.int32), t_rows, piece)
    counts = [max(1, -(-n // piece)) for n in lens]
    want, dst = [], []
    for r, (st, n) in enumerate(zip(starts, lens)):
        want += [(st + j, min(piece, n - j)) for j in range(0, n, piece)] or [
            (st, 0)]
        dst += [r if counts[r] == 1 else -1] * counts[r]
    cap = t_rows // piece + len(lens)
    assert len(want) <= cap == plan.starts.shape[0] == plan.dst.shape[0]
    assert plan.starts.dtype == plan.lens.dtype == plan.dst.dtype == torch.int32
    got = list(zip(plan.starts.tolist(), plan.lens.tolist()))
    assert got[:len(want)] == want and plan.dst.tolist()[:len(want)] == dst
    assert set(got[len(want):]) <= {(0, 0)}
    assert set(plan.dst.tolist()[len(want):]) <= {-1}
    assert plan.counts.tolist() == counts
    split = [r for r, c in enumerate(counts) if c > 1]
    offsets = list(np.cumsum([0] + counts[:-1]))
    assert int(plan.n_split) == len(split)
    assert plan.split.shape == (3, t_rows // (piece + 1) + 1)
    assert plan.split[:, :len(split)].tolist() == [
        [counts[r] for r in split], [offsets[r] for r in split], split]
    assert S.fold_depth(plan.counts.max()).item() == int(
        np.ceil(np.log2(max(counts))))


def test_finish_plan_builds_from_shapes_alone():
    """The finish's plan builds on the meta device, which has no values to
    read back: the hybrid path plans a batch's sets without a host
    wait."""
    nb, t_rows = 512, 64 * 1024
    starts = torch.empty(nb, dtype=torch.int32, device="meta")
    lens = torch.empty(nb, dtype=torch.int32, device="meta")
    plan = S.finish_plan(starts, lens, t_rows)
    assert plan.starts.device.type == "meta"
    assert plan.starts.shape == plan.dst.shape == (t_rows // S.PIECE + nb,)
    assert plan.split.shape == (3, t_rows // (S.PIECE + 1) + 1)
    assert plan.n_split.shape == (1,)


@pytest.mark.parametrize("pieces,depth", [(1, 0), (2, 1), (3, 2), (4, 2),
                                          (5, 3), (520, 10), (1 << 20, 20)])
def test_fold_depth(pieces, depth):
    assert S.fold_depth(torch.tensor(pieces)).item() == depth


def level_pairing(c):
    """The fold's pairing of pieces 0..c-1 as nested pairs (left, right):
    node i of a level is (node 2i, node 2i + 1) of the one before, an odd
    last node carried up."""
    lvl = list(range(c))
    while len(lvl) > 1:
        lvl = [tuple(lvl[i:i + 2]) if i + 1 < len(lvl) else lvl[i]
               for i in range(0, len(lvl), 2)]
    return lvl[0]


def lone_pairing(c, depth):
    """tree.cu's fold_lone on pieces 0..c-1, as nested pairs: a stack of
    partial sums by level that never holds more than depth of them."""
    st = []
    for j in range(c):
        q, k = j, 0
        while st and st[-1][1] == k:
            q, k = (st.pop()[0], q), k + 1
        st.append((q, k))
        assert len(st) <= depth
    r = st.pop()[0]
    while st:
        r = (st.pop()[0], r)
    return r


def test_lone_fold_pairs_as_the_levels():
    """The one-thread fold of a cut bucket adds the same nodes, operands in
    the same order, as the block's fold and the plain form's levels, for
    every piece count up to tree.cu's FOLD_LONE_MAX = 32, within a stack of
    bit_length(count) partial sums (its FOLD_LONE_DEPTH, bit_length(32))."""
    for c in range(1, 33):
        assert lone_pairing(c, c.bit_length()) == level_pairing(c), c


@pytest.mark.parametrize("lone", [1, 2, S.FOLD_LONE])
def test_fold_lone_counts_the_cut_buckets_of_at_most_fold_lone(
        lone, monkeypatch):
    """msm.fold_lone counts the cut buckets of 2 to smvp_stream.FOLD_LONE
    pieces, the count packed_finish hands the card's fold: one setting
    decides both; the sums do not depend on it."""
    from torch.profiler import ProfilerActivity, profile

    from webgpu_msm_bls12_377_tpu_torch.utils import trace

    group, piece = C.EDWARDS, S.PIECE
    lens = np.array([0, 1, piece, piece + 1, 2 * piece + 1, 8 * piece,
                     8 * piece + 1, 3 * piece])
    pieces = np.maximum(1, -(-lens // piece))
    starts = np.cumsum(np.concatenate([[0], lens[:-1]]))
    rows = S.node_rows(C.merge(group.zero(int(lens.sum()), "cpu")), group)
    layout = S.StreamLayout(
        starts_rk=torch.as_tensor(starts.astype(np.int32)),
        lens_rk=torch.as_tensor(lens.astype(np.int32)),
        perm=torch.arange(lens.size, dtype=torch.int32))
    want = S.packed_finish(rows, layout, group)
    monkeypatch.setattr(S, "FOLD_LONE", lone)
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = S.packed_finish(rows, layout, group)
        counted = trace.counters()
    finally:
        trace.reset()
    assert torch.equal(got, want)
    assert counted["msm.finish_split"] == (int((pieces > 1).sum()), 1)
    assert counted["msm.fold_lone"] == (
        int(((pieces > 1) & (pieces <= lone)).sum()), 1)


@pytest.mark.parametrize("max_len,piece,levels", [
    (0, 16, 0), (1, 16, 0), (16, 16, 0), (17, 16, 1), (32, 16, 1),
    (33, 16, 2), (1 << 14, 16, 10), (1 << 14, 8, 11), (1 << 10, 32, 5)])
def test_fold_levels(max_len, piece, levels):
    """ceil(log2(ceil(max_len / piece))) levels, none while one piece holds
    a bucket."""
    assert SK.fold_levels(max_len, piece) == levels


def test_piece_plan_builds_from_shapes_alone():
    """The plan and the fold's level maps build on the meta device, which
    has no values to read back: the batch's per-set stage needs no host
    wait for them."""
    nb, count, n = 512, 64 * 1024, 1024
    starts = torch.empty(nb, dtype=torch.int32, device="meta")
    lens = torch.empty(nb, dtype=torch.int32, device="meta")
    plan = SK.piece_plan(starts, lens, count, n)
    cap = count // SK.PIECE + nb
    assert plan.starts.device.type == "meta" and plan.starts.shape == (cap,)
    assert plan.caps == T.level_caps(cap, nb, SK.fold_levels(n, SK.PIECE))
    c_prev, s_prev = plan.counts, plan.offsets
    for t_cap in plan.caps:
        c_k = (c_prev + 1) >> 1
        s_k = torch.cumsum(c_k, 0) - c_k
        level_map = T.build_level_map(s_prev, c_prev, s_k, c_k, t_cap)
        assert level_map.device.type == "meta" and level_map.shape == (t_cap,)
        c_prev, s_prev = c_k, s_k


def test_default_2_14_chains_are_at_most_piece():
    """The 2^14 default (chunk 4, 64 windows of 8 buckets): the top
    window's one-bit bucket holds ~n/2 entries, and no piece, so no
    thread's chain of dependent adds, is longer than PIECE; the pieces
    cover every entry once."""
    n, chunk = 1 << 14, 4
    windows = decompose.num_windows_for(chunk)
    rng = np.random.default_rng(14)
    sw = rng.integers(0, 1 << 32, size=(8, n), dtype=np.int64)
    sw[7] &= (1 << 29) - 1
    plan = buckets.build_bucket_plan(
        decompose.decompose_scalars_signed(torch.from_numpy(sw), chunk,
                                           windows), chunk)
    assert int(plan.lens.max()) > n // 4
    count = plan.sorted_vals.shape[0]
    pp = SK.piece_plan(plan.starts, plan.lens, count, n)
    assert int(pp.lens.max()) == SK.PIECE
    assert int(pp.lens.sum()) == int(plan.lens.sum())
    assert len(pp.caps) == SK.fold_levels(n, SK.PIECE) == int(
        np.ceil(np.log2(n / SK.PIECE)))
    assert pp.starts.shape == (count // SK.PIECE + 8 * windows,)


def curve_points(group, count):
    """count affine points k*G, k = 1..count, and their Montgomery table."""
    g1 = group is C.G1
    gen, add, to_aff = ((crv.G1_GENERATOR, crv.g1_add, crv.g1_to_affine) if g1
                        else (crv.ED_GENERATOR, crv.ed_add, crv.ed_to_affine))
    pts, acc = [], gen
    for _ in range(count):
        pts.append(to_aff(acc))
        acc = add(acc, gen)
    mp = group.ctx.params
    coords = [[x for x, _ in pts], [y for _, y in pts]]
    if not g1:
        coords.append([x * y % mp.p for x, y in pts])
    return torch.cat([F.ints_to_plane([mp.to_mont(v) for v in c],
                                      nw=group.ctx.nw) for c in coords])


def same_points(got, want, group):
    """Column by column the same point: X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1
    (mod p; Z the last coordinate, so Edwards' T is left to the others),
    and the identity where the other has it."""
    nw, p = group.ctx.nw, group.ctx.p
    g, w = ([F.plane_to_ints(a[c * nw:(c + 1) * nw])
             for c in range(a.shape[0] // nw)] for a in (got, want))

    def is_zero(v, j):
        if group is C.G1:
            return v[2][j] % p == 0
        return v[0][j] % p == 0 and (v[1][j] - v[3][j]) % p == 0

    for j in range(got.shape[1]):
        for c in (0, 1):
            assert (g[c][j] * w[-1][j] - w[c][j] * g[-1][j]) % p == 0, j
        assert is_zero(g, j) == is_zero(w, j), j


@GROUPS
@pytest.mark.parametrize("piece", [2, 5])
def test_two_passes_equal_one_chain(group, piece):
    """Random signed rows of real points, buckets of 0, 1, piece, piece + 1
    rows and many pieces: accumulate_buckets_fused (plain forms of kernel
    8 over pieces, then the fold through kernel 2's full levels) against
    kernel 8's plain form over whole buckets (one chain each, the legacy
    order): the same words up to one piece, the same points beyond."""
    rng = random.Random(f"pieces{group.ctx.tag}{piece}")
    npts = 40
    rows = SK.make_wide_rows(curve_points(group, npts), group)
    lens = [0, 1, piece, piece + 1, 0, 9 * piece + 1, 3, 0, 2 * piece]
    count = sum(lens)
    vals = [rng.randrange(npts) | (rng.randrange(2) << buckets.SIGN_BIT)
            for _ in range(count)]
    gathered = SK.pregather_signed(rows, torch.tensor(vals, dtype=torch.int32),
                                   group)
    starts = torch.tensor(np.cumsum([0] + lens[:-1]), dtype=torch.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    want = SK.accumulate_buckets_fused_plain(gathered, starts, lens_t, group)
    got = SK.accumulate_buckets_fused(gathered, starts, lens_t, group,
                                      piece=piece, max_len=max(lens))
    short = lens_t <= piece
    assert torch.equal(got[:, short], want[:, short])
    assert not torch.equal(got[:, ~short], want[:, ~short])
    same_points(got, want, group)
    order = torch.tensor([3, 0, 8, 5, 1, 7, 2, 6, 4])
    assert torch.equal(
        SK.accumulate_buckets_fused(gathered, starts, lens_t, group,
                                    piece=piece, max_len=max(lens),
                                    order=order), got[:, order])
