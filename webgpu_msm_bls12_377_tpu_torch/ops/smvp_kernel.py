"""The fused segment SMVP: the whole bucket accumulation over pre-gathered
rows, in two passes (kernel 8, then the fold of csrc/tree.cu).

After the per-window sort each bucket's entries are contiguous in sorted
order.  pregather_signed materializes the sorted point rows once (one row
gather in sorted_vals order, the digit's sign applied: to y for G1, to x
and t for Edwards), so every bucket's segment is a contiguous run of rows.
accumulate_buckets_fused then cuts each segment into pieces of at most
PIECE consecutive rows (piece_plan), sums every piece with the canonical
complete mixed add, from the identity and in order, one thread a piece
(kernel 8, fused_segments), and folds each bucket's pieces pairwise, level
by level, with the lazy full add (fold_pieces: the tree path's pairing,
the last node canonical; on the card one launch of msm_fold_pieces, one
block a bucket; the plain form is kernel 2's full levels); the windowed
form runs kernel 8 window by window and one fold for all windows.  The chain of
dependent adds a thread walks is at most PIECE long instead of a bucket's
length (about n/2 in the top window of chunk 4).  A bucket of at most PIECE rows
is one piece and passes the fold unchanged: its sum is the legacy path's,
word for word; a longer one is the same point in other projective
coordinates.

Nothing here reads the device back: the piece plane is sized from shapes
alone (count // PIECE + B pieces; the plain fold's ceil(log2(ceil(max_len
/ PIECE))) levels, max_len a bound on a bucket's length), so the path
runs in a batch without a host wait.

A row is ROW_WORDS = 32 int32 words: G1 x, y and six zero words; Edwards
x, y, t and five zero words (the signed table's row, ops/smvp_stream.py).
Both curves run the same code with the group (ops/curve.py: G1, the
default, or EDWARDS).  The JAX package's 128-word rows, its 32-row DMA
tiles and trailing pad rows, the (blocks, 1, 256) segment reshape and the
per-block round counts serve the TPU's DMA and lane tiling and have no
counterpart here; fused_supported and windowed_supported keep that
package's arithmetic as policy only (where its engine takes this path on
a TPU): the kernels themselves run any bucket count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import curve as C
from . import field as F
from . import smvp_tree as T
from .buckets import IDX_MASK, SIGN_BIT
from .kernels import check_plane, launch, on_cuda
from .smvp_stream import ROW_WORDS

G1 = C.G1
#: rows one thread of kernel 8 sums in a chain before the fold takes over
#: (8, 16 and 32 measured at the 2^14 and 2^10 defaults, PERF.md: 32 the
#: fastest on both curves)
PIECE = 32
#: bucket lanes of one kernel block and rows of one DMA tile on the TPU;
#: the *_supported policies keep them
TPU_BLOCK = 256
TPU_R_TILE = 32


def windowed_supported(num_buckets: int, num_windows: int, n: int) -> bool:
    """True where the JAX engine runs its fused path window by window on a
    TPU: a window's buckets fill whole 256-lane blocks and n >= 32."""
    return (num_buckets // num_windows) % TPU_BLOCK == 0 and n >= TPU_R_TILE


def fused_supported(num_buckets: int, total: int) -> bool:
    """True where the JAX engine can run its fused path as one dispatch on
    a TPU: all buckets fill whole 256-lane blocks and there are >= 32
    entries."""
    return num_buckets % TPU_BLOCK == 0 and total >= TPU_R_TILE


def make_wide_rows(table: torch.Tensor, group=G1) -> torch.Tensor:
    """Montgomery affine table -> row-major gather table with the negated
    sign-dependent coordinates appended, so one row gather fetches both
    signs: G1 (26, N) (x; y) -> (N, 39) rows [x, y, -y]; Edwards (27, N)
    (x; y; t) -> (N, 45) rows [x, y, t, -x, -t]."""
    check_plane(table, group.aff_rows)
    nw = group.ctx.nw
    neg = [F.field_neg(table[c * nw:(c + 1) * nw], group.ctx)
           for c in group.signed_coords]
    return torch.cat([table, *neg], dim=0).T.contiguous()


def pregather_signed(rows: torch.Tensor, sorted_vals: torch.Tensor,
                     group=G1) -> torch.Tensor:
    """Signed point rows in sorted order: (count, ROW_WORDS) int32, the
    affine coordinates (G1 [x, y|-y], Edwards [x|-x, y, t|-t]) in words
    [0, aff_rows) and zeros after them.

    rows: the make_wide_rows table; sorted_vals: the (count,) slice of the
    sorted entry stream to materialize (one window's entries, or all)."""
    nw = group.ctx.nw
    v = sorted_vals.to(torch.int64)
    g = rows[v & IDX_MASK]
    sign_pos = (((v >> SIGN_BIT) & 1) == 1)[:, None]
    out = torch.zeros((v.shape[0], ROW_WORDS), dtype=torch.int32,
                      device=rows.device)
    out[:, :group.aff_rows] = g[:, :group.aff_rows]
    for i, c in enumerate(group.signed_coords):
        neg = group.aff_rows + i * nw
        out[:, c * nw:(c + 1) * nw] = torch.where(
            sign_pos, g[:, c * nw:(c + 1) * nw], g[:, neg:neg + nw])
    return out


# ---------------------------------------------------------------------------
# The piece plan
# ---------------------------------------------------------------------------


class PiecePlan(NamedTuple):
    starts: torch.Tensor  # (cap,) int32 piece segments in the rows
    lens: torch.Tensor  # (cap,) int32 piece lengths, 0 past the real pieces
    counts: torch.Tensor  # (B,) int64 pieces of each bucket
    offsets: torch.Tensor  # (B,) int64 column of each bucket's first piece
    caps: list[int]  # plane sizes of the fold levels (their count: levels)


def fold_levels(max_len: int, piece: int) -> int:
    """Pairwise levels that fold ceil(max_len / piece) pieces into one."""
    return max(0, -(-max_len // piece) - 1).bit_length()


def piece_plan(starts: torch.Tensor, lens: torch.Tensor, count: int,
               max_len: int, piece: int = PIECE) -> PiecePlan:
    """Cut bucket b's segment [starts[b], starts[b] + lens[b]) of `count`
    rows into pieces of at most `piece` rows: piece j of bucket b is
    column offsets[b] + j, offsets the exclusive cumsum of counts =
    ceil(lens / piece).  The plane has count // piece + B columns, a bound
    on the piece count; max_len bounds a bucket's length and fixes the fold
    levels.  Built on the tensors' device from shapes alone: each column
    takes its bucket's segment by the delta-scatter-plus-cumsum of
    smvp_tree.build_level_map."""
    nb = starts.shape[0]
    s, ln = starts.to(torch.int64), lens.to(torch.int64)
    counts = (ln + piece - 1) // piece
    offsets = torch.cumsum(counts, 0) - counts
    cap = count // piece + nb
    iota = torch.arange(cap, dtype=torch.int64, device=s.device)

    def spread(v):
        # v of each column's bucket: buckets whose pieces start at or past
        # cap own no column, and empty buckets' deltas cancel
        delta = torch.cat([v[:1], v[1:] - v[:-1]])
        plane = torch.zeros(cap + 1, dtype=torch.int64, device=s.device)
        plane.index_add_(0, offsets.clamp(max=cap), delta)
        return torch.cumsum(plane[:cap], 0)

    real = iota < offsets[-1] + counts[-1]
    first = piece * iota + spread(s - piece * offsets)
    size = (spread(s + ln) - first).clamp(max=piece)
    return PiecePlan(
        starts=torch.where(real, first, 0).to(torch.int32),
        lens=torch.where(real, size, 0).to(torch.int32),
        counts=counts, offsets=offsets,
        caps=T.level_caps(cap, nb, fold_levels(max_len, piece)))


# ---------------------------------------------------------------------------
# Kernel 8: segment sums (pass 1)
# ---------------------------------------------------------------------------


def fused_round(acc, gathered, starts, lens, t, group=G1):
    """Round t of the plain form: every segment longer than t adds its row
    t.  starts, lens: int64."""
    live = t < lens
    row = gathered[torch.where(live, starts + t, 0)]
    new = group.add_mixed(acc, group.split_aff(row[:, :group.aff_rows].T))
    return group.select(live, new, acc)


def accumulate_buckets_fused_plain(
    gathered: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
    group=G1,
) -> torch.Tensor:
    """Plain form of kernel 8: lockstep rounds up to the longest segment."""
    starts = starts.to(torch.int64)
    lens = lens.to(torch.int64)
    acc = group.zero(starts.shape[0], gathered.device)
    max_len = int(lens.max()) if lens.numel() else 0
    for t in range(max_len):
        acc = fused_round(acc, gathered, starts, lens, t, group)
    return C.merge(acc)


def check_segments(gathered: torch.Tensor, starts: torch.Tensor,
                   lens: torch.Tensor) -> int:
    if gathered.dim() != 2 or gathered.shape[1] != ROW_WORDS:
        raise ValueError(
            f"expected (count, {ROW_WORDS}) rows, got {tuple(gathered.shape)}"
        )
    nb = starts.shape[0]
    if starts.shape != (nb,) or lens.shape != (nb,):
        raise ValueError("starts and lens must be (B,) vectors of one length")
    return nb


def fused_segments(
    gathered: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
    group=G1,
) -> torch.Tensor:
    """(count, 32) pre-gathered signed rows, (S,) int32 segment starts and
    lengths -> (39|36, S) canonical segment sums in the order of starts:
    per segment, the canonical complete mixed-add sum, from the identity,
    of rows starts[s] .. starts[s] + lens[s] - 1 (empty: the identity)."""
    ns = check_segments(gathered, starts, lens)
    if not on_cuda(gathered, starts, lens):
        return accumulate_buckets_fused_plain(gathered, starts, lens, group)
    out = torch.empty((group.rows, ns), dtype=torch.int32,
                      device=gathered.device)
    tag = group.ctx.tag
    launch("fused" + tag, "msm_fused_buckets", "fused_buckets" + tag, ns,
           gathered.data_ptr(), starts.data_ptr(), lens.data_ptr(),
           out.data_ptr(), ns, device=out.device)
    return out


# ---------------------------------------------------------------------------
# The fold (pass 2: csrc/tree.cu msm_fold_pieces) and the two passes
# together
# ---------------------------------------------------------------------------


def fold_pieces_plain(sums: torch.Tensor, counts: torch.Tensor,
                      offsets: torch.Tensor, caps: list[int], group=G1):
    """Plain form of fold_pieces: kernel 2's full levels (their plain
    form), one a level of caps, each over every bucket's nodes of the
    level before (the tree path's level maps), then each bucket's last
    node canonicalized."""
    nb = counts.shape[0]
    lvl, c_prev, s_prev = sums, counts, offsets
    for cap in caps:
        c_k = (c_prev + 1) >> 1
        s_k = torch.cumsum(c_k, 0) - c_k
        level_map = T.build_level_map(s_prev, c_prev, s_k, c_k, cap)
        lvl = T.tree_level_plain(lvl, level_map, "full", False, group=group)
        c_prev, s_prev = c_k, s_k
    # an empty bucket's column may lie past the plane: it is replaced below
    col = s_prev.to(torch.int64).clamp(max=lvl.shape[1] - 1)
    node = group.canon(group.split(lvl[:, col]))
    out = group.select(counts > 0, node, group.zero(nb, sums.device))
    return C.merge(out), torch.arange(nb, device=sums.device)


def fold_pieces(sums: torch.Tensor, counts: torch.Tensor,
                offsets: torch.Tensor, caps: list[int], group=G1):
    """Fold each bucket's pieces pairwise, level by level: node i of a level
    is node 2i + node 2i+1 of the one before within the bucket, an odd last
    node carried up unchanged (the tree path's pairing); the last node is
    canonicalized.  Bucket b's counts[b] piece sums sit in columns
    offsets[b].. of sums (the piece plan's layout).  Returns (plane,
    s_fin): the (39|36, B) plane whose column b is bucket b's sum (the
    identity for an empty bucket), and s_fin = arange(B), the column of
    each bucket's sum, as permute_tree reads it.

    On the card one launch folds every bucket, one block a bucket, each
    through its own levels only; caps (the plane sizes of the fold's
    levels, enough for the longest bucket) serve the plain form."""
    nb = counts.shape[0]
    cols = check_plane(sums, group.rows)
    counts32, offsets32 = (v.to(torch.int32) for v in (counts, offsets))
    if not on_cuda(sums, counts32, offsets32):
        return fold_pieces_plain(sums, counts, offsets, caps, group)
    out = torch.empty((group.rows, nb), dtype=torch.int32, device=sums.device)
    scratch = torch.empty_like(sums)
    tag = group.ctx.tag
    launch("tree" + tag, "msm_fold_pieces", "fold_pieces" + tag, nb,
           sums.data_ptr(), cols, counts32.data_ptr(), offsets32.data_ptr(),
           scratch.data_ptr(), out.data_ptr(), nb, device=out.device)
    return out, torch.arange(nb, device=sums.device)


def accumulate_buckets_fused(
    gathered: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
    group=G1, *, piece: int = PIECE, max_len: int | None = None, order=None,
) -> torch.Tensor:
    """(count, 32) pre-gathered signed rows, (B,) int32 bucket segment
    starts and lengths -> (39|36, B) canonical bucket sums in the order of
    starts, or buckets[order] when order (e.g. ops/bpr.py:bpr_order) is
    given: per bucket, the canonical mixed-add sums of its pieces of at
    most `piece` rows, folded pairwise (empty buckets: the identity).
    max_len bounds a bucket's length (default count; a bucket of window w
    holds at most one entry a point, so n does)."""
    check_segments(gathered, starts, lens)
    on_cuda(gathered, starts, lens)  # raises for operands no kernel takes
    count = gathered.shape[0]
    plan = piece_plan(starts, lens, count,
                      count if max_len is None else max_len, piece)
    sums = fused_segments(gathered, plan.starts, plan.lens, group)
    final, s_fin = fold_pieces(sums, plan.counts, plan.offsets, plan.caps,
                               group)
    return T.permute_tree(final, s_fin, lens, order, group)


def accumulate_buckets_windowed(
    rows: torch.Tensor,
    sorted_vals: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    num_windows: int,
    group=G1,
    *,
    piece: int = PIECE,
    order=None,
) -> torch.Tensor:
    """The fused SMVP with kernel 8 window by window: one pre-gather and
    one pass over its pieces per window, so the pre-gathered rows never
    exceed N (2 GiB in one piece at 2^20 and chunk 16, 128 MiB a window),
    then one fold of every window's pieces.  Returns what
    accumulate_buckets_fused does for the whole plan.

    rows: the make_wide_rows table; starts/lens: window-major per-bucket
    segments over all windows.  Window w's entries are the N-long slice
    w of sorted_vals (its first bucket starts at w*N)."""
    n = rows.shape[0]
    h = starts.shape[0] // num_windows
    sums, counts, offsets = [], [], []
    for w in range(num_windows):
        gathered = pregather_signed(rows, sorted_vals[w * n:(w + 1) * n], group)
        plan = piece_plan(starts[w * h:(w + 1) * h] - w * n,
                          lens[w * h:(w + 1) * h], n, n, piece)
        sums.append(fused_segments(gathered, plan.starts, plan.lens, group))
        counts.append(plan.counts)
        offsets.append(plan.offsets + w * plan.starts.shape[0])
    cols = num_windows * plan.starts.shape[0]
    caps = T.level_caps(cols, num_windows * h, fold_levels(n, piece))
    final, s_fin = fold_pieces(torch.cat(sums, dim=1), torch.cat(counts),
                               torch.cat(offsets), caps, group)
    return T.permute_tree(final, s_fin, lens, order, group)
