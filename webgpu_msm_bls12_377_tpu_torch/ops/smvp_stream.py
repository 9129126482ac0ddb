"""The stream SMVP over the sorted entry stream, the hybrid finish over
packed level-K nodes, and the bucket permute.

build_stream_layout sorts each window's buckets by descending length
(stable, as the JAX package's lax.sort), so bucket rank r of a window
sits beside buckets of similar length.  Kernels 3 and 5 give every real
bucket one thread in that rank order; the sum it writes lands in column
w*h + rank of a block-ordered plane that permute_buckets reorders.
Kernel 5 (accumulate_buckets_streamed) sums a bucket's signed table
points, kernel 3 (packed_finish) its level-K tree nodes.

The JAX package streams 256-lane slabs through a sequential grid, whose
slab maps live in the TPU's SMEM and cap the slab count
(SLAB_SMEM_CAP).  This port has no slabs and so no cap: a
duplicate-heavy input runs through either path like any other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import curve as C
from . import field as F
from .buckets import IDX_MASK, SIGN_BIT
from .field import NW
from .kernels import AFF_ROWS, check_plane, launch, on_cuda

G1 = C.G1Ops()
ROWS = C.N_COORDS * NW
#: lanes of one slab on the TPU; stream_supported keeps its policy
TPU_SLAB_LANES = 256


def stream_supported(chunk_size: int) -> bool:
    """True where the JAX engine's "auto" policy takes the stream path on
    a TPU: a window's 2^(chunk_size-1) buckets fill whole 256-lane slabs
    (chunk_size >= 9).  Kernel 5 itself has no lane constraint."""
    return (1 << (chunk_size - 1)) % TPU_SLAB_LANES == 0


def build_signed_table(table: torch.Tensor) -> torch.Tensor:
    """(26, N) Montgomery affine (x; y) plane -> (26, 2N) signed table:
    columns [0, N) hold (x, y), columns [N, 2N) hold (x, -y).  One table
    serves the stream kernel and tree level 1."""
    check_plane(table, AFF_ROWS)
    x, y = table[:NW], table[NW:]
    return torch.cat(
        [table, torch.cat([x, F.field_neg(y)], dim=0)], dim=1
    ).contiguous()


def signed_rows(table: torch.Tensor, sorted_vals: torch.Tensor, i):
    """Affine (x, y) of sorted-stream entries i from the signed table."""
    n = table.shape[1] // 2
    v = sorted_vals[i].to(torch.int64)
    col = (v & IDX_MASK) + torch.where(((v >> SIGN_BIT) & 1) == 1, 0, n)
    cols = table[:, col]
    return cols[:NW], cols[NW:]


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
) -> torch.Tensor:
    """Plain form of kernel 5 on (B,) rank-order starts/lens."""
    starts = starts_rk.to(torch.int64)
    lens = lens_rk.to(torch.int64)
    acc = G1.zero(starts.shape[0], signed_table.device)
    max_len = int(lens.max()) if lens.numel() else 0
    for t in range(max_len):
        live = t < lens
        idx = torch.where(live, starts + t, 0)
        new = G1.add_mixed_lazy_pair(
            acc, signed_rows(signed_table, sorted_vals, idx)
        )
        acc = G1.select(live, new, acc)
    return C.merge(G1.canon(acc))


def accumulate_buckets_streamed(
    signed_table: torch.Tensor, sorted_vals: torch.Tensor, layout: StreamLayout
) -> torch.Tensor:
    """(26, 2N) signed table, sorted entry stream -> (39, B) canonical
    bucket sums, column r the bucket of rank r (layout order): per bucket,
    the lazy mixed-add sum, from the identity, of its entries' signed
    points in stream order.  Any bucket length and any chunk size run."""
    check_plane(signed_table, AFF_ROWS)
    starts, lens = layout.starts_rk, layout.lens_rk
    if not on_cuda(signed_table, sorted_vals, starts, lens):
        return accumulate_buckets_streamed_plain(
            signed_table, sorted_vals, starts, lens
        )
    nb = starts.shape[0]
    out = torch.empty((ROWS, nb), dtype=torch.int32, device=signed_table.device)
    launch("stream", "msm_stream_buckets", "stream_buckets", nb,
           signed_table.data_ptr(), signed_table.shape[1] // 2,
           sorted_vals.data_ptr(), starts.data_ptr(), lens.data_ptr(),
           out.data_ptr(), nb)
    return out


# ---------------------------------------------------------------------------
# Kernel 3: packed finish
# ---------------------------------------------------------------------------


def packed_finish_plain(
    plane: torch.Tensor, starts_rk: torch.Tensor, lens_rk: torch.Tensor
) -> torch.Tensor:
    """Plain form of kernel 3 on (B,) rank-order starts/lens."""
    starts = starts_rk.to(torch.int64)
    lens = lens_rk.to(torch.int64)
    acc = G1.zero(starts.shape[0], plane.device)
    max_len = int(lens.max()) if lens.numel() else 0
    for t in range(max_len):
        live = t < lens
        idx = torch.where(live, starts + t, 0)
        new = G1.add_lazy_pair(acc, C.split(plane[:, idx]))
        acc = G1.select(live, new, acc)
    return C.merge(G1.canon(acc))


def packed_finish(plane: torch.Tensor, layout: StreamLayout) -> torch.Tensor:
    """(39, T_K) level-K plane -> (39, B) canonical bucket sums, column r
    the bucket of rank r (layout order)."""
    check_plane(plane, ROWS)
    starts, lens = layout.starts_rk, layout.lens_rk
    if not on_cuda(plane, starts, lens):
        return packed_finish_plain(plane, starts, lens)
    nb = starts.shape[0]
    out = torch.empty((ROWS, nb), dtype=torch.int32, device=plane.device)
    launch("packed", "msm_packed_finish", "packed_finish", nb,
           plane.data_ptr(), plane.shape[1], starts.data_ptr(),
           lens.data_ptr(), out.data_ptr(), nb)
    return out


def permute_buckets(
    blocks: torch.Tensor, layout: StreamLayout, order=None
) -> torch.Tensor:
    """Block-ordered (39, B) plane -> window-major buckets, or
    buckets[order.reshape(-1)] when order (an array or tensor, e.g.
    ops/bpr.py:bpr_order) is given: one column gather.  Empty buckets
    become the identity."""
    perm = layout.perm.to(torch.int64)
    if order is not None:
        perm = perm[torch.as_tensor(order, device=perm.device).reshape(-1)
                    .to(torch.int64)]
    sel = blocks[:, perm]
    nonempty = layout.lens_rk[perm] > 0
    zero = G1.zero(1, blocks.device)
    return C.merge(G1.select(nonempty, C.split(sel), zero))
