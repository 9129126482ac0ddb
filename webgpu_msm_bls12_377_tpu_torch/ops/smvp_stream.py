"""The stream SMVP over the sorted entry stream, the hybrid finish over
packed level-K nodes, and the bucket permute.

build_stream_layout sorts each window's buckets by descending length
(stable, as the JAX package's lax.sort), so bucket rank r of a window
sits beside buckets of similar length.  Kernels 3 and 5 give every real
bucket one thread in that rank order; the sum it writes lands in column
w*h + rank of a block-ordered plane that permute_buckets reorders.
Kernel 5 (accumulate_buckets_streamed) sums a bucket's signed table
points, kernel 3 (packed_finish) its level-K tree nodes, which the last
tree level writes as rows (node_rows is the plain form of that layout).
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


def packed_finish_plain(
    rows: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor, group=G1,
) -> torch.Tensor:
    """Plain form of kernel 3 on (B,) starts/lens: per column, the nodes
    from the identity in row order."""
    starts = starts.to(torch.int64)
    lens = lens.to(torch.int64)
    acc = group.zero(starts.shape[0], rows.device)
    max_len = int(lens.max()) if lens.numel() else 0
    for t in range(max_len):
        live = t < lens
        idx = torch.where(live, starts + t, 0)
        new = group.add_lazy(acc, group.split(rows[idx, :group.rows].T))
        acc = group.select(live, new, acc)
    return C.merge(group.canon(acc))


def packed_finish(rows: torch.Tensor, layout: StreamLayout,
                  group=G1) -> torch.Tensor:
    """(T_K, node_words) level-K node rows (the hybrid tree's last level)
    -> (39|36, B) canonical bucket sums, column r the bucket of the
    layout's column r: the sum of rows [starts_rk[r], starts_rk[r] +
    lens_rk[r]) from the identity.  While a profiler records, the longest
    chain a thread walks (the largest lens_rk) goes to the counter
    msm.finish_chain, left on the device."""
    w = node_words(group)
    if rows.dim() != 2 or rows.shape[1] != w:
        raise ValueError(f"expected (T, {w}) node rows, got {tuple(rows.shape)}")
    starts, lens = layout.starts_rk, layout.lens_rk
    if trace.recording() and lens.numel():
        trace.count("msm.finish_chain", lens.max())
    if not on_cuda(rows, starts, lens):
        return packed_finish_plain(rows, starts, lens, group)
    nb = starts.shape[0]
    out = torch.empty((group.rows, nb), dtype=torch.int32, device=rows.device)
    tag = group.ctx.tag
    launch("packed" + tag, "msm_packed_finish", "packed_finish" + tag, nb,
           rows.data_ptr(), starts.data_ptr(), lens.data_ptr(),
           out.data_ptr(), nb, device=out.device)
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
