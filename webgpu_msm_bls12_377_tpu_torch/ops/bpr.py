"""Bucket reduction by parallel running sums (cuZK Algorithm 4).

- stage 1: every (window, thread) lane walks its block of bpt buckets
  from the top down, keeping the running sums m (bucket total) and g
  (weighted total): bpt - 1 launches of kernel 4's running add;
- stage 2: g += m * s for the static per-lane scalar
  s = bpt * (num_threads - thread - 1) = k << b, b = log2(bpt): b lazy
  doublings of m, then a double-and-add over k's bits;
- window fold: log2(num_threads) shift-reduce adds at a fixed lane shape,
  after which lane 0 of each window holds the window sum.
The whole reduction stays in the lazy domain and canonicalizes the
num_windows results once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import curve as C
from .field import NW
from .kernels import bpr_add, bpr_double, bpr_masked_add_double, bpr_running_add

ROWS = C.N_COORDS * NW


def bpr_order(num_windows: int, chunk_size: int, num_threads: int) -> np.ndarray:
    """Static (bpt, lanes) window-major bucket index per (step, lane).

    Row 0 is each lane's m/g seed, row st >= 1 the bucket its running sums
    consume at step st."""
    h = 1 << (chunk_size - 1)
    tc = min(num_threads, h)
    if tc < 1 or tc & (tc - 1):
        raise ValueError(f"num_threads must be a power of two, got {num_threads}")
    bpt = h // tc
    wi = np.repeat(np.arange(num_windows, dtype=np.int32), tc)
    tf = np.tile(np.arange(tc, dtype=np.int32), num_windows)
    base = wi * h + (tc - tf) * bpt
    idx0 = np.where(tf == 0, wi * h, base)
    return np.stack([idx0] + [base - st for st in range(1, bpt)])


@functools.lru_cache(maxsize=8)
def bpr_order_on(
    num_windows: int, chunk_size: int, num_threads: int, device
) -> torch.Tensor:
    """bpr_order flattened to a (bpt*lanes,) int64 tensor on device.
    Cached and read-only: the walk is static, and a copy from host memory
    makes the host wait for the device's stream."""
    order = bpr_order(num_windows, chunk_size, num_threads)
    return torch.as_tensor(order.reshape(-1), device=device).to(torch.int64)


def reduce_buckets_prearranged(
    buckets_bpr: torch.Tensor,
    num_windows: int,
    chunk_size: int,
    num_threads: int = 256,
) -> torch.Tensor:
    """Window sums from buckets gathered in bpr_order.

    buckets_bpr: (39, bpt*lanes) canonical plane, column st*lanes + lane =
    buckets[bpr_order[st, lane]].  Returns the (39, num_windows)
    canonical window sums."""
    h = 1 << (chunk_size - 1)
    t_count = min(num_threads, h)
    bpt = h // t_count
    lanes = num_windows * t_count
    # step-major (bpt, 39, lanes): every step's operand is contiguous
    steps = buckets_bpr.reshape(ROWS, bpt, lanes).permute(1, 0, 2).contiguous()
    m = g = steps[0]
    for st in range(1, bpt):
        m, g = bpr_running_add(m, g, steps[st])
    return _bpr_stage2_and_fold(m, g, num_windows, t_count, bpt)


@functools.lru_cache(maxsize=8)
def _stage2_consts(num_windows: int, t_count: int, device):
    """Static per-lane tables of stage 2 and the fold, on device (cached
    and read-only, as bpr_order_on): the (nbits, lanes) bits of each
    lane's k, the fold's partner lanes per step, and lane 0 of each
    window."""
    wi = np.repeat(np.arange(num_windows, dtype=np.int64), t_count)
    tf = np.tile(np.arange(t_count, dtype=np.int64), num_windows)
    k_lane = t_count - 1 - tf
    nbits = max(int(k_lane.max()).bit_length(), 1)
    bit_table = torch.as_tensor(
        np.stack([(k_lane >> b) & 1 for b in range(nbits)]).astype(np.int32),
        device=device,
    )
    # lane i reads partner i + off, in-window for every lane that still
    # feeds lane 0; the other lanes read a clamped partner and compute
    # values nothing reads
    partners = []
    off = t_count // 2
    while off >= 1:
        partners.append(torch.as_tensor(
            wi * t_count + np.minimum(tf + off, t_count - 1), device=device
        ))
        off //= 2
    lane0 = torch.as_tensor(np.arange(num_windows) * t_count, device=device)
    return bit_table, partners, lane0


def _bpr_stage2_and_fold(m, g, num_windows, t_count, bpt):
    """Stage 2 (g += m * s) and the per-window shift-reduce fold."""
    bit_table, partners, lane0 = _stage2_consts(num_windows, t_count, m.device)
    temp = m
    for _ in range(max(bpt.bit_length() - 1, 0)):
        temp = bpr_double(temp)
    for bits in bit_table:
        g, temp = bpr_masked_add_double(g, temp, bits)
    for partner in partners:
        g = bpr_add(g, g[:, partner].contiguous())
    return C.merge(C.G1Ops().canon(C.split(g[:, lane0])))
