"""The fused segment SMVP: the whole bucket accumulation in one kernel
over pre-gathered rows (kernel 8).

After the per-window sort each bucket's entries are contiguous in sorted
order.  pregather_signed materializes the sorted point rows once (one row
gather in sorted_vals order, the digit's sign applied to y), so every
bucket's segment is a contiguous run of rows; accumulate_buckets_fused
then sums each segment with the canonical complete mixed add, from the
identity and in order, as the legacy path does round by round: both give
the same canonical projective coordinates.

A row is ROW_WORDS = 32 int32 words (x, y, six zero words): the least
width that keeps every 26-word point 16-byte aligned.  The JAX package's
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
from .field import NW
from .kernels import AFF_ROWS, ROWS, check_plane, launch, on_cuda

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


def make_wide_rows(table: torch.Tensor) -> torch.Tensor:
    """(26, N) Montgomery affine (x; y) plane -> (N, 39) row-major gather
    table, row = [x, y, -y]: one row gather fetches both signs of y."""
    check_plane(table, AFF_ROWS)
    return torch.cat([table, F.field_neg(table[NW:])], dim=0).T.contiguous()


def pregather_signed(rows: torch.Tensor, sorted_vals: torch.Tensor) -> torch.Tensor:
    """Signed point rows in sorted order: (count, ROW_WORDS) int32.

    rows: the make_wide_rows table; sorted_vals: the (count,) slice of the
    sorted entry stream to materialize (one window's entries, or all)."""
    v = sorted_vals.to(torch.int64)
    g = rows[v & IDX_MASK]
    sign_pos = (((v >> SIGN_BIT) & 1) == 1)[:, None]
    out = torch.zeros((v.shape[0], ROW_WORDS), dtype=torch.int32,
                      device=rows.device)
    out[:, :NW] = g[:, :NW]
    out[:, NW:AFF_ROWS] = torch.where(sign_pos, g[:, NW:AFF_ROWS], g[:, AFF_ROWS:])
    return out


# ---------------------------------------------------------------------------
# Kernel 8: fused segment SMVP
# ---------------------------------------------------------------------------


def fused_round(acc, gathered, starts, lens, t):
    """Round t of the plain form: every bucket longer than t adds its row
    t.  starts, lens: int64; t: an int, or a 0-dim int64 tensor on the
    device (one round captured in a CUDA graph and replayed)."""
    live = t < lens
    row = gathered[torch.where(live, starts + t, 0)]
    new = G1.add_mixed(acc, (row[:, :NW].T, row[:, NW:AFF_ROWS].T))
    return G1.select(live, new, acc)


def accumulate_buckets_fused_plain(
    gathered: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor
) -> torch.Tensor:
    """Plain form of kernel 8: lockstep rounds up to the longest bucket."""
    starts = starts.to(torch.int64)
    lens = lens.to(torch.int64)
    acc = G1.zero(starts.shape[0], gathered.device)
    max_len = int(lens.max()) if lens.numel() else 0
    for t in range(max_len):
        acc = fused_round(acc, gathered, starts, lens, t)
    return C.merge(acc)


def accumulate_buckets_fused(
    gathered: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor
) -> torch.Tensor:
    """(count, 32) pre-gathered signed rows, (B,) int32 segment starts and
    lengths -> (39, B) canonical bucket sums in the order of starts: per
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
        return accumulate_buckets_fused_plain(gathered, starts, lens)
    out = torch.empty((ROWS, nb), dtype=torch.int32, device=gathered.device)
    launch("fused", "msm_fused_buckets", "fused_buckets", nb,
           gathered.data_ptr(), starts.data_ptr(), lens.data_ptr(),
           out.data_ptr(), nb)
    return out


def accumulate_buckets_windowed(
    rows: torch.Tensor,
    sorted_vals: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    num_windows: int,
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
        gathered = pregather_signed(rows, sorted_vals[w * n:(w + 1) * n])
        out.append(accumulate_buckets_fused(
            gathered, starts[w * h:(w + 1) * h] - w * n, lens[w * h:(w + 1) * h]
        ))
    return torch.cat(out, dim=1)
