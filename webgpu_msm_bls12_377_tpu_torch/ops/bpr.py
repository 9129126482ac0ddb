"""Bucket reduction by parallel running sums (cuZK Algorithm 4).

- stage 1: every (window, thread) lane walks its block of bpt buckets
  from the top down, keeping the running sums m (bucket total) and g
  (weighted total): one launch of kernel 4's bpr_stage1, each lane's walk
  split into stage1_split sub-walks so that the launch fills the card;
- stage 2: g += m * s for the static per-lane scalar
  s = bpt * (num_threads - thread - 1) = k << b, b = log2(bpt): b lazy
  doublings of m, then a double-and-add over k's bits, one launch of
  kernel 4's bpr_stage2 (a thread runs a lane's chain);
- window fold: the log2(num_threads) shift-reduce levels' adds that feed
  each window's lane 0, one launch of bpr_fold (a block a window).
The whole reduction stays in the lazy domain and canonicalizes the
num_windows results once.  It serves both curves: the group (ops/curve.py:
G1, the default, or EDWARDS) picks the planes and the kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import curve as C
from .curve import G1
from .kernels import MAX_SPLIT, bpr_fold, bpr_stage1, bpr_stage2

#: stage-1 threads an H100 holds at once, by curve (ops/field.py tag):
#: 132 SMs x 128 threads x the blocks a SM that bpr_stage1's registers
#: allow (csrc/bpr.cu STAGE1_MIN_BLOCKS 2 with the carry-chain product: G1
#: 255: 2; Edwards 142: 3).  stage1_split keeps lanes * split
#: within it: a second, partial wave cost more than the shorter sub-walks
#: saved (at 2^17 G1 split 4 ran 2.4 ms, split 2 1.8 ms).
STAGE1_RESIDENT = {"": 132 * 128 * 2, "_ed": 132 * 128 * 3}


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


def bpr_order_on(
    num_windows: int, chunk_size: int, num_threads: int, device
) -> torch.Tensor:
    """bpr_order flattened to a (bpt*lanes,) int64 tensor on device.
    Cached per device and read-only: the walk is static, and a copy from
    host memory makes the host wait for the device's stream.  A CUDA
    device without an index is keyed as the current one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _bpr_order_cached(num_windows, chunk_size, num_threads, dev)


@functools.lru_cache(maxsize=16)
def _bpr_order_cached(num_windows, chunk_size, num_threads, device):
    order = bpr_order(num_windows, chunk_size, num_threads)
    return torch.as_tensor(order.reshape(-1), device=device).to(torch.int64)


def stage1_split(lanes: int, bpt: int, group=G1) -> int:
    """Sub-walks a lane's stage-1 walk is split into: the largest power
    of two, at most bpt and MAX_SPLIT, that keeps lanes * split within
    STAGE1_RESIDENT (1 where the lanes alone fill the card)."""
    resident = STAGE1_RESIDENT[group.ctx.tag]
    split = 1
    while split * 2 <= min(bpt, MAX_SPLIT) and lanes * split * 2 <= resident:
        split *= 2
    return split


def reduce_buckets_prearranged(
    buckets_bpr: torch.Tensor,
    num_windows: int,
    chunk_size: int,
    num_threads: int = 256,
    group=G1,
) -> torch.Tensor:
    """Window sums from buckets gathered in bpr_order.

    buckets_bpr: (39|36, bpt*lanes) canonical plane, column st*lanes +
    lane = buckets[bpr_order[st, lane]].  Returns the (39|36, num_windows)
    canonical window sums: the JAX package's words where stage 1 runs
    unsplit or in sub-walks of one step (stage1_split 1, or bpt), the
    same points in other projective coordinates otherwise."""
    h = 1 << (chunk_size - 1)
    t_count = min(num_threads, h)
    bpt = h // t_count
    lanes = num_windows * t_count
    if bpt == 1:  # no steps: each lane's m and g are its one bucket
        m = g = buckets_bpr
    else:
        m, g = bpr_stage1(buckets_bpr, bpt, stage1_split(lanes, bpt, group),
                          group)
    return _bpr_stage2_and_fold(m, g, num_windows, t_count, bpt, group)


def _bpr_stage2_and_fold(m, g, num_windows, t_count, bpt, group):
    """Stage 2 (g += m * s) and the per-window shift-reduce fold, one
    launch each; the window sums canonicalized."""
    g = bpr_stage2(m, g, t_count, bpt, group)
    sums = bpr_fold(g, num_windows, t_count, group)
    return C.merge(group.canon(group.split(sums)))
