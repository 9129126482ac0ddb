"""The fused segment SMVP: the whole bucket accumulation in one kernel
over pre-gathered rows (kernel 8).

After the per-window sort each bucket's entries are contiguous in sorted
order.  pregather_signed materializes the sorted point rows once (one row
gather in sorted_vals order, the digit's sign applied: to y for G1, to x
and t for Edwards), so every
bucket's segment is a contiguous run of rows; accumulate_buckets_fused
then sums each segment with the canonical complete mixed add, from the
identity and in order, as the legacy path does round by round: both give
the same canonical projective coordinates.

A row is ROW_WORDS = 32 int32 words: G1 x, y and six zero words; Edwards
x, y, t and five zero words.  32 is the least width that keeps every
26- or 27-word point 16-byte aligned.  Both curves run the same code with
the group (ops/curve.py: G1, the default, or EDWARDS).  The JAX package's
128-word rows, its 32-row DMA tiles and trailing pad rows, the
(blocks, 1, 256) segment reshape and the per-block round counts serve the
TPU's DMA and lane tiling and have no counterpart here; fused_supported
and windowed_supported keep that package's arithmetic as policy only
(where its engine takes this path on a TPU): the kernel itself runs any
bucket count.
"""

from __future__ import annotations

import torch

from . import curve as C
from . import field as F
from .buckets import IDX_MASK, SIGN_BIT
from .kernels import check_plane, launch, on_cuda

G1 = C.G1
ROW_WORDS = 32
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
# Kernel 8: fused segment SMVP
# ---------------------------------------------------------------------------


def fused_round(acc, gathered, starts, lens, t, group=G1):
    """Round t of the plain form: every bucket longer than t adds its row
    t.  starts, lens: int64; t: an int, or a 0-dim int64 tensor on the
    device (one round captured in a CUDA graph and replayed)."""
    live = t < lens
    row = gathered[torch.where(live, starts + t, 0)]
    new = group.add_mixed(acc, group.split_aff(row[:, :group.aff_rows].T))
    return group.select(live, new, acc)


def accumulate_buckets_fused_plain(
    gathered: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
    group=G1,
) -> torch.Tensor:
    """Plain form of kernel 8: lockstep rounds up to the longest bucket."""
    starts = starts.to(torch.int64)
    lens = lens.to(torch.int64)
    acc = group.zero(starts.shape[0], gathered.device)
    max_len = int(lens.max()) if lens.numel() else 0
    for t in range(max_len):
        acc = fused_round(acc, gathered, starts, lens, t, group)
    return C.merge(acc)


def accumulate_buckets_fused(
    gathered: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
    group=G1,
) -> torch.Tensor:
    """(count, 32) pre-gathered signed rows, (B,) int32 segment starts and
    lengths -> (39|36, B) canonical bucket sums in the order of starts: per
    bucket, the canonical complete mixed-add sum, from the identity, of rows
    starts[b] .. starts[b] + lens[b] - 1 (empty buckets: the identity)."""
    if gathered.dim() != 2 or gathered.shape[1] != ROW_WORDS:
        raise ValueError(
            f"expected (count, {ROW_WORDS}) rows, got {tuple(gathered.shape)}"
        )
    nb = starts.shape[0]
    if starts.shape != (nb,) or lens.shape != (nb,):
        raise ValueError("starts and lens must be (B,) vectors of one length")
    if not on_cuda(gathered, starts, lens):
        return accumulate_buckets_fused_plain(gathered, starts, lens, group)
    out = torch.empty((group.rows, nb), dtype=torch.int32,
                      device=gathered.device)
    tag = group.ctx.tag
    launch("fused" + tag, "msm_fused_buckets", "fused_buckets" + tag, nb,
           gathered.data_ptr(), starts.data_ptr(), lens.data_ptr(),
           out.data_ptr(), nb)
    return out


def accumulate_buckets_windowed(
    rows: torch.Tensor,
    sorted_vals: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    num_windows: int,
    group=G1,
) -> torch.Tensor:
    """The fused SMVP window by window: one pre-gather and one launch per
    window, so the pre-gathered rows never exceed N (2 GiB in one piece at
    2^20 and chunk 16, 128 MiB a window).

    rows: the make_wide_rows table; starts/lens: window-major per-bucket
    segments over all windows.  Window w's entries are the N-long slice
    w of sorted_vals (its first bucket starts at w*N)."""
    n = rows.shape[0]
    h = starts.shape[0] // num_windows
    out = []
    for w in range(num_windows):
        gathered = pregather_signed(rows, sorted_vals[w * n:(w + 1) * n], group)
        out.append(accumulate_buckets_fused(
            gathered, starts[w * h:(w + 1) * h] - w * n,
            lens[w * h:(w + 1) * h], group
        ))
    return torch.cat(out, dim=1)
