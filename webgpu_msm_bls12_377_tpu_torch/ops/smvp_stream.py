"""The stream SMVP over the sorted entry stream, the hybrid finish over
packed level-K nodes, and the bucket permute.

build_stream_layout sorts each window's buckets by descending length
(stable, as the JAX package's lax.sort), so bucket rank r of a window
sits beside buckets of similar length.  Both kernels write a bucket's sum
to column w*h + rank of a block-ordered plane that permute_buckets
reorders.  Kernel 5 (accumulate_buckets_streamed) gives every real bucket
one thread in that rank order and sums its signed table points.  The
finish (packed_finish) sums a bucket's level-K tree nodes, which the last
tree level writes as rows (node_rows is the plain form of that layout): a
bucket of at most PIECE nodes on one thread of kernel 3, a longer one in
pieces of PIECE nodes, one thread a piece, folded pairwise by tree.cu's
fold (finish_plan lays the pieces out, in the same rank order).
Every function here serves both curves: it takes the group
(ops/curve.py: G1, the default, or EDWARDS), whose planes are (26|39, .)
for G1 and (27|36, .) for Edwards.

The JAX package streams 256-lane slabs through a sequential grid, whose
slab maps live in the TPU's SMEM and cap the slab count
(SLAB_SMEM_CAP).  This port has no slabs and so no cap: a
duplicate-heavy input runs through either path like any other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import curve as C
from .buckets import check_signed_table, signed_rows
from ..utils import trace
from .curve import G1
# the signed table's plain form lives beside kernel 1, which builds it
from .kernels import ROW_WORDS, build_signed_table, check_plane, launch, on_cuda

#: lanes of one slab on the TPU; stream_supported keeps its policy
TPU_SLAB_LANES = 256
#: node rows one thread of the finish sums in a chain before the fold
#: takes over.  Uniform scalars leave the top window of a 2^20 MSM ~32
#: level-2 nodes a bucket (at most ~46): 32 cut half of those buckets in
#: two, and the fold of the halves cost that finish 4-10 % on an H100,
#: where 48 and 64 cut none; at 64 zipf_2p18's ~16,600-node bucket walks
#: 64 nodes and 9 fold levels, at 48 48 and 9 (PERF.md)
PIECE = 48
#: the fold sums a cut bucket of at most this many pieces on one thread,
#: a longer one on a block of threads (passed to tree.cu's
#: msm_fold_split, which takes at most its FOLD_LONE_MAX = 32).  8 against
#: 4, 16 and 32 on an H100: the fastest at zipf_2p18, within 8 % at a
#: uniform 2^24 finish (PERF.md)
FOLD_LONE = 8


def stream_supported(chunk_size: int) -> bool:
    """True where the JAX engine's "auto" policy takes the stream path on
    a TPU: a window's 2^(chunk_size-1) buckets fill whole 256-lane slabs
    (chunk_size >= 9).  Kernel 5 itself has no lane constraint."""
    return (1 << (chunk_size - 1)) % TPU_SLAB_LANES == 0


class StreamLayout(NamedTuple):
    starts_rk: torch.Tensor  # (num_buckets,) segment starts, rank order
    lens_rk: torch.Tensor  # (num_buckets,) segment lengths, rank order
    perm: torch.Tensor  # (num_buckets,) rank column of bucket (w, j)


def build_stream_layout(
    starts: torch.Tensor, lens: torch.Tensor, num_windows: int
) -> StreamLayout:
    """Length-sorted layout from window-major per-bucket segments."""
    h = starts.shape[0] // num_windows
    lens_w = lens.reshape(num_windows, h).to(torch.int64)
    _, order = torch.sort(-lens_w, dim=1, stable=True)
    lens_rk = lens_w.gather(1, order)
    starts_rk = starts.reshape(num_windows, h).to(torch.int64).gather(1, order)
    iota = torch.arange(h, device=order.device).expand(num_windows, h)
    inv = torch.empty_like(order).scatter_(1, order, iota)
    base = (torch.arange(num_windows, device=order.device) * h)[:, None]
    return StreamLayout(
        starts_rk=starts_rk.reshape(-1).to(torch.int32),
        lens_rk=lens_rk.reshape(-1).to(torch.int32),
        perm=(inv + base).reshape(-1).to(torch.int32),
    )


# ---------------------------------------------------------------------------
# Kernel 5: stream SMVP
# ---------------------------------------------------------------------------


def accumulate_buckets_streamed_plain(
    signed_table: torch.Tensor,
    sorted_vals: torch.Tensor,
    starts_rk: torch.Tensor,
    lens_rk: torch.Tensor,
    group=G1,
) -> torch.Tensor:
    """Plain form of kernel 5 on (B,) rank-order starts/lens."""
    starts = starts_rk.to(torch.int64)
    lens = lens_rk.to(torch.int64)
    acc = group.zero(starts.shape[0], signed_table.device)
    max_len = int(lens.max()) if lens.numel() else 0
    for t in range(max_len):
        live = t < lens
        idx = torch.where(live, starts + t, 0)
        new = group.add_mixed_lazy(
            acc, signed_rows(signed_table, sorted_vals, idx, group)
        )
        acc = group.select(live, new, acc)
    return C.merge(group.canon(acc))


def accumulate_buckets_streamed(
    signed_table: torch.Tensor, sorted_vals: torch.Tensor,
    layout: StreamLayout, group=G1,
) -> torch.Tensor:
    """Signed table ((2N, 32)), sorted entry stream -> (39|36, B)
    canonical bucket sums, column r the bucket of rank r (layout order):
    per bucket, the lazy mixed-add sum, from the identity, of its entries'
    signed points in stream order.  Any bucket length and any chunk size
    run."""
    n_points = check_signed_table(signed_table)
    starts, lens = layout.starts_rk, layout.lens_rk
    if not on_cuda(signed_table, sorted_vals, starts, lens):
        return accumulate_buckets_streamed_plain(
            signed_table, sorted_vals, starts, lens, group
        )
    nb = starts.shape[0]
    out = torch.empty((group.rows, nb), dtype=torch.int32,
                      device=signed_table.device)
    tag = group.ctx.tag
    launch("stream" + tag, "msm_stream_buckets", "stream_buckets" + tag, nb,
           signed_table.data_ptr(), n_points,
           sorted_vals.data_ptr(), starts.data_ptr(), lens.data_ptr(),
           out.data_ptr(), nb, device=out.device)
    return out


# ---------------------------------------------------------------------------
# Kernel 3: packed finish
# ---------------------------------------------------------------------------


def node_words(group=G1) -> int:
    """Words of one node row (csrc/curve.cuh NODE_WORDS): the point's
    rows rounded up to a multiple of four, G1 40, Edwards 36."""
    return (group.rows + 3) // 4 * 4


def node_rows(plane: torch.Tensor, group=G1) -> torch.Tensor:
    """(39|36, T) limb-major node plane -> the (T, node_words) row-major
    node array the finish reads: row j holds column j's words, then
    zeros."""
    t = check_plane(plane, group.rows)
    out = torch.zeros((t, node_words(group)), dtype=torch.int32,
                      device=plane.device)
    out[:, :group.rows] = plane.T
    return out


class FinishPlan(NamedTuple):
    starts: torch.Tensor  # (cap,) int32 first node row of each piece
    lens: torch.Tensor  # (cap,) int32 piece lengths, 0 past the real pieces
    dst: torch.Tensor  # (cap,) int32 output column of a one-piece bucket, else -1
    counts: torch.Tensor  # (B,) int64 pieces of each bucket (at least one)
    split: torch.Tensor  # (3, split cap + 1) int32 pieces, first piece, column
    n_split: torch.Tensor  # (1,) int64 buckets cut into two or more pieces


def finish_plan(starts: torch.Tensor, lens: torch.Tensor, t_rows: int,
                piece: int = PIECE) -> FinishPlan:
    """Cut bucket r's rows [starts[r], starts[r] + lens[r]) of T = t_rows
    node rows into counts[r] = max(1, ceil(lens[r] / piece)) pieces of at
    most `piece` rows: piece j of bucket r is column offsets[r] + j,
    offsets the exclusive cumsum of counts.  A one-piece bucket's piece
    names its output column r in dst; the buckets of two or more pieces
    fill the first n_split slots of `split` in column order, each with its
    piece count, its first piece's column and r.

    The buckets' rows are disjoint (the tree's levels lay them out so), so
    the T // piece + B piece columns and T // (piece + 1) slots bound what
    any plan needs: everything is built on the tensors' device from shapes
    alone, with no value read back."""
    nb, dev = starts.shape[0], starts.device
    ln = lens.to(torch.int64)
    counts = ((ln + piece - 1) // piece).clamp(min=1)
    offsets = torch.cumsum(counts, 0) - counts
    per_bucket = torch.stack([starts.to(torch.int64), ln, counts, offsets,
                              torch.arange(nb, device=dev)])
    cap = t_rows // piece + nb
    # the bucket of each column: one mark at each bucket's first column
    mark = torch.zeros(cap, dtype=torch.int64, device=dev)
    mark.index_fill_(0, offsets[1:], 1)
    b = torch.cumsum(mark, 0)
    s_b, ln_b, count_b, off_b, _ = per_bucket[:, b]
    j = torch.arange(cap, device=dev) - off_b
    real = j < count_b
    pieces = torch.stack([
        torch.where(real, s_b + piece * j, 0),
        (ln_b - piece * j).clamp(0, piece),
        torch.where(real & (count_b == 1), b, -1)]).to(torch.int32)
    split = counts > 1
    slot = torch.cumsum(split, 0)
    slots = t_rows // (piece + 1)
    # slot `slots` takes every one-piece bucket and is never read
    table = torch.zeros((3, slots + 1), dtype=torch.int64, device=dev)
    table.scatter_(1, torch.where(split, slot - 1, slots).expand(3, nb),
                   per_bucket[2:])
    return FinishPlan(starts=pieces[0], lens=pieces[1], dst=pieces[2],
                      counts=counts, split=table.to(torch.int32),
                      n_split=slot[-1:])


def fold_depth(pieces: torch.Tensor) -> torch.Tensor:
    """ceil(log2(pieces)) for a tensor of piece counts >= 1: the pairwise
    levels that fold that many pieces into one, on the tensor's device."""
    pow2 = torch.ones((), dtype=torch.int64, device=pieces.device) << \
        torch.arange(62, device=pieces.device)
    return (pow2 < pieces.to(torch.int64)[..., None]).sum(-1)


def packed_finish_plain(
    rows: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor, group=G1,
) -> torch.Tensor:
    """Plain form of the finish (kernel 3's piece pass, then tree.cu's
    fold) on (B,) starts/lens: per piece of at most PIECE rows (the
    plan's), its rows from the identity in row order; per bucket its
    pieces folded pairwise (ops/smvp_kernel.py:fold_pieces_plain, the
    pairing of the fused path's fold), the last node canonical."""
    from .smvp_kernel import fold_levels, fold_pieces_plain
    from .smvp_tree import level_caps

    nb = starts.shape[0]
    plan = finish_plan(starts, lens, int(lens.to(torch.int64).sum()))
    p_starts = plan.starts.to(torch.int64)
    p_lens = plan.lens.to(torch.int64)
    acc = group.zero(p_starts.shape[0], rows.device)
    for t in range(int(p_lens.max()) if p_lens.numel() else 0):
        live = t < p_lens
        idx = torch.where(live, p_starts + t, 0)
        new = group.add_lazy(acc, group.split(rows[idx, :group.rows].T))
        acc = group.select(live, new, acc)
    offsets = torch.cumsum(plan.counts, 0) - plan.counts
    max_len = int(lens.max()) if nb else 0
    caps = level_caps(p_starts.shape[0], nb, fold_levels(max_len, PIECE))
    return fold_pieces_plain(C.merge(acc), plan.counts, offsets, caps,
                             group)[0]


def packed_finish(rows: torch.Tensor, layout: StreamLayout, group=G1,
                  plan: FinishPlan | None = None) -> torch.Tensor:
    """(T_K, node_words) level-K node rows (the hybrid tree's last level)
    -> (39|36, B) canonical bucket sums, column r the bucket of the
    layout's column r: the sum of rows [starts_rk[r], starts_rk[r] +
    lens_rk[r]) from the identity, in pieces of at most PIECE rows folded
    pairwise.  plan: finish_plan of the layout over these rows (built here
    where not given).

    On the card two launches: kernel 3 (packed.cu) sums every piece, one
    thread a piece, and writes a one-piece bucket's canonical sum; the
    fold (tree.cu msm_fold_split) folds the pieces of the buckets cut in
    two or more, a bucket of at most FOLD_LONE pieces on one thread, a
    longer one on a block.  While a profiler records, the longest chain of
    dependent adds a thread walks (the longest piece, then the fold's
    levels of the bucket with the most pieces) goes to the counter
    msm.finish_chain, the buckets cut to msm.finish_split and those of them
    folded on one thread to msm.fold_lone (on the card the fold counts
    them, with no launch of its own), all left on the device."""
    w = node_words(group)
    if rows.dim() != 2 or rows.shape[1] != w:
        raise ValueError(f"expected (T, {w}) node rows, got {tuple(rows.shape)}")
    starts, lens = layout.starts_rk, layout.lens_rk
    if plan is None:
        plan = finish_plan(starts, lens, rows.shape[0])
    counting = trace.recording() and lens.numel() > 0
    if counting:
        trace.count("msm.finish_chain",
                    plan.lens.max() + fold_depth(plan.counts.max()))
        trace.count("msm.finish_split", plan.n_split)
    if not on_cuda(rows, starts, lens):
        if counting:
            trace.count("msm.fold_lone",
                        ((plan.counts > 1) & (plan.counts <= FOLD_LONE)).sum())
        return packed_finish_plain(rows, starts, lens, group)
    nb, cap = starts.shape[0], plan.starts.shape[0]
    out = torch.empty((group.rows, nb), dtype=torch.int32, device=rows.device)
    sums = torch.empty((group.rows, cap), dtype=torch.int32,
                       device=rows.device)
    tag = group.ctx.tag
    launch("packed" + tag, "msm_packed_finish", "packed_finish" + tag, cap,
           rows.data_ptr(), plan.starts.data_ptr(), plan.lens.data_ptr(),
           plan.dst.data_ptr(), sums.data_ptr(), cap, out.data_ptr(), nb,
           device=out.device)
    scratch = torch.empty_like(sums)
    counts, offsets, cols = plan.split
    lone = torch.empty(1, dtype=torch.int64, device=rows.device) \
        if counting else None
    launch("tree" + tag, "msm_fold_split", "finish_fold" + tag,
           plan.split.shape[1], sums.data_ptr(), cap, counts.data_ptr(),
           offsets.data_ptr(), cols.data_ptr(), plan.n_split.data_ptr(),
           scratch.data_ptr(), out.data_ptr(), nb, plan.split.shape[1],
           FOLD_LONE, None if lone is None else lone.data_ptr(),
           device=out.device)
    if counting:
        trace.count("msm.fold_lone", lone)
    return out


def permute_buckets(
    blocks: torch.Tensor, layout: StreamLayout, order=None, group=G1
) -> torch.Tensor:
    """Block-ordered (39|36, B) plane -> window-major buckets, or
    buckets[order.reshape(-1)] when order (an array or tensor, e.g.
    ops/bpr.py:bpr_order) is given: one column gather.  Empty buckets
    become the group's identity."""
    perm = layout.perm.to(torch.int64)
    if order is not None:
        perm = perm[torch.as_tensor(order, device=perm.device).reshape(-1)
                    .to(torch.int64)]
    sel = blocks[:, perm]
    nonempty = layout.lens_rk[perm] > 0
    zero = group.zero(1, blocks.device)
    return C.merge(group.select(nonempty, group.split(sel), zero))
