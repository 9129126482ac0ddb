"""Bucket plan: (window, point) digit pairs -> sorted bucket segments.

Signed-bucket mapping for a stored digit d, h = 2^(s-1):
  d == h      -> digit 0, skipped (sorts past every real bucket);
  d >  h      -> bucket slot d-h, positive;
  0 < d < h   -> bucket slot h-d, negative;
  d == 0      -> bucket slot 0 (weight h, the "top" bucket), negative.
One stable sort per window row orders the entries by slot; segment
bounds then give each bucket's start and length.  The sort is stable, as
the JAX package's lax.sort is, so the plan matches it entry for entry.

legacy_buckets is the legacy SMVP over such a plan, for either curve:
kernel 6 sums every segment (a bucket, or a piece of one) of the sorted
entry stream with the canonical complete mixed add, from the identity and
in entry order, one thread a segment, reading each addend's row of the
row-major signed table (kernel 1's SIGNED form) with its sign applied.
Its plain form runs the TPU's lockstep rounds of the masked mixed add
(ops/kernels.py:masked_add_mixed_plain), as many as the longest segment;
the two agree bit for bit.  accumulate_buckets keeps the JAX package's
signature (a Montgomery table and a round count) over the same kernel.
The JAX package's row-major copy (table_to_rows), its per-round gathers
and their batching (GATHER_BATCH, a TPU gather-latency device) have no
counterpart: the kernel reads the signed table's rows itself.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import curve as C
from .kernels import (
    ROW_WORDS,
    build_signed_table,
    launch,
    masked_add_mixed_plain,
    on_cuda,
)

SIGN_BIT = 30
IDX_MASK = (1 << SIGN_BIT) - 1


class BucketPlan(NamedTuple):
    sorted_vals: torch.Tensor  # (K*N,) int32: point idx | sign_pos << 30
    starts: torch.Tensor  # (K*h,) int32 global segment offsets
    lens: torch.Tensor  # (K*h,) int32 segment lengths


def build_bucket_plan(digits: torch.Tensor, chunk_size: int) -> BucketPlan:
    """digits: (num_windows, N) stored signed digits (decompose)."""
    num_windows, n = digits.shape
    h = 1 << (chunk_size - 1)
    d = digits.to(torch.int64)
    slot = torch.where(d == 0, 0, torch.where(d > h, d - h, h - d))
    sign_pos = (d > h).to(torch.int64)
    keys = torch.where(d != h, slot, h)
    ids = torch.arange(n, device=d.device).expand(num_windows, n)
    vals = ids | (sign_pos << SIGN_BIT)
    sorted_keys, order = torch.sort(keys, dim=1, stable=True)
    sorted_vals = vals.gather(1, order)
    bounds = segment_bounds(sorted_keys, h)  # (K, h+1) row-local
    row_base = (torch.arange(num_windows, device=d.device) * n)[:, None]
    starts = bounds[:, :-1] + row_base
    lens = bounds[:, 1:] - bounds[:, :-1]
    return BucketPlan(
        sorted_vals=sorted_vals.reshape(-1).to(torch.int32),
        starts=starts.reshape(-1).to(torch.int32),
        lens=lens.reshape(-1).to(torch.int32),
    )


def segment_bounds(sorted_keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """bounds[..., b] = #{i : sorted_keys[..., i] < b}, b in 0..num_buckets,
    for each independently sorted row of sorted_keys (k, m)."""
    q = torch.arange(num_buckets + 1, device=sorted_keys.device)
    q = q.expand(sorted_keys.shape[0], -1).contiguous()
    return torch.searchsorted(sorted_keys.contiguous(), q, side="left")


def check_signed_table(table: torch.Tensor) -> int:
    """Points of a signed table (2N, ROW_WORDS): N."""
    if table.dim() != 2 or table.shape[1] != ROW_WORDS or table.shape[0] % 2:
        raise ValueError(
            f"expected a (2N, {ROW_WORDS}) signed table, got {tuple(table.shape)}")
    return table.shape[0] // 2


def signed_rows(table: torch.Tensor, sorted_vals: torch.Tensor, i, group=C.G1):
    """Affine coordinates of sorted-stream entries i from the signed
    table."""
    n = check_signed_table(table)
    v = sorted_vals[i].to(torch.int64)
    row = (v & IDX_MASK) + torch.where(((v >> SIGN_BIT) & 1) == 1, 0, n)
    return group.split_aff(table[row, :group.aff_rows].T)


def round_class(max_len: int, step: int = 16) -> int:
    """Legacy SMVP round count of the JAX package: the maximum bucket
    length rounded up to a multiple of step (its classes, used there per
    window group; the port's kernel runs each bucket's own length)."""
    m = max(int(max_len), 1)
    return -(-m // step) * step


def window_slice_indices(windows, h: int) -> np.ndarray:
    """Bucket indices of a window subset (window-major layout)."""
    return np.concatenate(
        [np.arange(w * h, (w + 1) * h, dtype=np.int64) for w in windows]
    )


def legacy_buckets_plain(table, sorted_vals, starts, lens, group=C.G1):
    """Plain form of legacy_buckets: lockstep rounds of
    masked_add_mixed_plain, round t adding entry t of every segment
    longer than t (its row of the signed table, the sign already applied),
    as many rounds as the longest segment."""
    ns = starts.shape[0]
    acc = C.merge(group.zero(ns, table.device))
    starts = starts.to(torch.int64)
    last = max(sorted_vals.shape[0] - 1, 0)
    ones = torch.ones(ns, dtype=torch.int32, device=table.device)
    for t in range(int(lens.max()) if ns else 0):
        aff = C.merge(signed_rows(table, sorted_vals,
                                  (starts + t).clamp(max=last), group))
        acc = masked_add_mixed_plain(acc, aff, ones,
                                     (t < lens).to(torch.int32), group)
    return acc


def legacy_buckets(table: torch.Tensor, sorted_vals: torch.Tensor,
                   starts: torch.Tensor, lens: torch.Tensor,
                   group=C.G1) -> torch.Tensor:
    """The legacy SMVP in one launch of kernel 6: per segment s, the
    canonical complete mixed-add sum, from the identity and in order, of
    entries starts[s] .. starts[s] + lens[s] - 1 of the sorted entry
    stream (point index | positive-sign bit 30), each the row of the (2N,
    ROW_WORDS) signed table that holds its signed point.  Returns the
    (39|36, S) canonical plane in the order of starts (an empty segment:
    the identity), bit for bit the TPU's lockstep rounds of
    masked_add_mixed."""
    n_points = check_signed_table(table)
    ns = starts.shape[0]
    if starts.shape != (ns,) or lens.shape != (ns,) or sorted_vals.dim() != 1:
        raise ValueError("sorted_vals, starts and lens must be vectors, "
                         "starts and lens of one length")
    if not on_cuda(table, sorted_vals, starts, lens):
        return legacy_buckets_plain(table, sorted_vals, starts, lens, group)
    out = torch.empty((group.rows, ns), dtype=torch.int32, device=table.device)
    tag = group.ctx.tag
    launch("legacy" + tag, "msm_legacy_buckets", "legacy_buckets" + tag, ns,
           table.data_ptr(), n_points, sorted_vals.data_ptr(),
           starts.data_ptr(), lens.data_ptr(), out.data_ptr(), ns,
           device=out.device)
    return out


def accumulate_buckets(
    table: torch.Tensor, plan: BucketPlan, num_rounds: int, group=C.G1
) -> torch.Tensor:
    """The JAX package's legacy SMVP: per-bucket signed point sums of
    num_rounds lockstep rounds, so entries past num_rounds are left out
    (round_class makes it at least the longest bucket).

    table: Montgomery affine plane, G1 (26, N) (x; y) or Edwards (27, N)
    (x; y; t); plan.starts / plan.lens may cover a subset of the buckets.
    Returns the (39|36, B) canonical bucket plane in the order of
    plan.starts (empty buckets: the identity): legacy_buckets over the
    signed table built from it."""
    return legacy_buckets(build_signed_table(table, group), plan.sorted_vals,
                          plan.starts, plan.lens.clamp(max=num_rounds), group)
