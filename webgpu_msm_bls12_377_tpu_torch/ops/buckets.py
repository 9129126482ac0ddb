"""Bucket plan: (window, point) digit pairs -> sorted bucket segments.

Signed-bucket mapping for a stored digit d, h = 2^(s-1):
  d == h      -> digit 0, skipped (sorts past every real bucket);
  d >  h      -> bucket slot d-h, positive;
  0 < d < h   -> bucket slot h-d, negative;
  d == 0      -> bucket slot 0 (weight h, the "top" bucket), negative.
One stable sort per window row orders the entries by slot; segment
bounds then give each bucket's start and length.  The sort is stable, as
the JAX package's lax.sort is, so the plan matches it entry for entry.

accumulate_buckets is the legacy SMVP over such a plan: every bucket of a
window group advances in lockstep, round t adding entry t of each bucket
with kernel 6 (the masked canonical mixed add), for either curve.  The
point table stays the limb-major (26|27, N) plane: a round's column
gather yields the (26|27, B) operand the kernel reads, so the JAX
package's row-major copy (table_to_rows) is not needed, and neither is
its batching of several rounds' gathers into one (GATHER_BATCH, a TPU
gather-latency device).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import curve as C
from .kernels import masked_add_mixed

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


def round_class(max_len: int, step: int = 16) -> int:
    """Legacy SMVP round count: the maximum bucket length rounded up to a
    multiple of step (the JAX package's classes; used per window group,
    since the top scalar window has far denser buckets than the rest)."""
    m = max(int(max_len), 1)
    return -(-m // step) * step


def window_slice_indices(windows, h: int) -> np.ndarray:
    """Bucket indices of a window subset (window-major layout)."""
    return np.concatenate(
        [np.arange(w * h, (w + 1) * h, dtype=np.int64) for w in windows]
    )


def accumulate_buckets(
    table: torch.Tensor, plan: BucketPlan, num_rounds: int, group=C.G1
) -> torch.Tensor:
    """Legacy SMVP: per-bucket signed point sums in lockstep rounds.

    table: Montgomery affine plane, G1 (26, N) (x; y) or Edwards (27, N)
    (x; y; t); plan.starts / plan.lens may cover a subset of the buckets;
    num_rounds must be at least the longest of them (round_class).  Returns
    the (39|36, B) canonical bucket plane in the order of plan.starts
    (empty buckets: the identity)."""
    num_buckets = plan.starts.shape[0]
    total = plan.sorted_vals.shape[0]
    starts = plan.starts.to(torch.int64)
    acc = C.merge(group.zero(num_buckets, table.device))
    for t in range(num_rounds):
        v = plan.sorted_vals[(starts + t).clamp(max=total - 1)]
        aff = table[:, (v & IDX_MASK).to(torch.int64)]
        sign_pos = (v >> SIGN_BIT) & 1
        valid = (t < plan.lens).to(torch.int32)
        acc = masked_add_mixed(acc, aff, sign_pos, valid, group)
    return acc
