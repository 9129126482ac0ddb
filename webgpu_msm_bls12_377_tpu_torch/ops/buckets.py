"""Bucket plan: (window, point) digit pairs -> sorted bucket segments.

Signed-bucket mapping for a stored digit d, h = 2^(s-1):
  d == h      -> digit 0, skipped (sorts past every real bucket);
  d >  h      -> bucket slot d-h, positive;
  0 < d < h   -> bucket slot h-d, negative;
  d == 0      -> bucket slot 0 (weight h, the "top" bucket), negative.
One stable sort per window row orders the entries by slot; segment
bounds then give each bucket's start and length.  The sort is stable, as
the JAX package's lax.sort is, so the plan matches it entry for entry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
