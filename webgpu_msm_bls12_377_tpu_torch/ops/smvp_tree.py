"""Packed segmented-tree SMVP: the hybrid form (tree levels 1..K, then the
packed finish of ops/smvp_stream.py, its pieces planned with the levels)
and the pure tree (every level, until each bucket is one node).

Level 1 pairs adjacent same-bucket entries of the sorted entry stream
(both-affine adds) and every later level pairs adjacent nodes of the
previous level's packed output.  Level k stores bucket b's
c_k[b] = ceil(c_{k-1}[b] / 2) nodes at S_k[b] = exclusive-cumsum(c_k),
c_0 = bucket lengths.  Node p's children sit at childA(p) = 2p + off(b(p))
and childA + 1 of the previous level, where off = S_{k-1} - 2 S_k is
constant per bucket: the level map stores that absolute child index per
node, with FLAG_SINGLE (one child: promote or copy) and FLAG_INVALID
(past the level's real node count: identity).

The level planes are sized by a static bound, T_k <= (T_{k-1} + B)/2
with T_0 the entry count and B the bucket count, so the plan needs no
host readback.  Each window ends with a phantom bucket that covers its
skipped zero-digit tail: with it, off changes by at most one between
consecutive buckets, window boundaries included, for any input.  Phantom
nodes are computed and never read.

The pure tree's level count is ceil(log2(longest bucket)): the one value
its caller reads back from the device (TreePlan.max_len).

The plans are the same for both curves; the levels, the tree and the
permute take the group (ops/curve.py: G1, the default, or EDWARDS).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import curve as C
from .buckets import check_signed_table, signed_rows
from .curve import G1
from .kernels import check_plane, launch, on_cuda
from .smvp_stream import (
    FinishPlan,
    StreamLayout,
    build_stream_layout,
    finish_plan,
    node_rows,
    node_words,
    packed_finish,
)

FLAG_INVALID = 1 << 29
FLAG_SINGLE = 1 << 30
CHILD_MASK = FLAG_INVALID - 1


def extend_with_phantom(
    starts: torch.Tensor, lens: torch.Tensor, kn: int, num_windows: int
):
    """Append one phantom bucket per window covering the window's skipped
    zero-digit tail; returns (starts_e, lens_e), (num_windows*(h+1),)."""
    h = lens.shape[0] // num_windows
    n_row = kn // num_windows
    s2 = starts.reshape(num_windows, h)
    l2 = lens.reshape(num_windows, h)
    row_end = (torch.arange(num_windows, device=starts.device) + 1) * n_row
    tail_start = s2[:, -1] + l2[:, -1]
    tail_len = row_end - tail_start
    starts_e = torch.cat([s2, tail_start[:, None].to(s2.dtype)], dim=1)
    lens_e = torch.cat([l2, tail_len[:, None].to(l2.dtype)], dim=1)
    return starts_e.reshape(-1), lens_e.reshape(-1)


def real_bucket_view(arr_e: torch.Tensor, num_windows: int) -> torch.Tensor:
    """(num_windows*(h+1),) phantom-extended array -> (num_windows*h,)."""
    he = arr_e.shape[0] // num_windows
    return arr_e.reshape(num_windows, he)[:, : he - 1].reshape(-1)


def level_caps(kn: int, num_buckets: int, levels: int) -> list[int]:
    """Static plane sizes of levels 1..levels: T_k <= (T_{k-1} + B) / 2."""
    caps, prev = [], kn
    for _ in range(levels):
        prev = (prev + num_buckets) // 2
        caps.append(prev)
    return caps


def chain_counts(lens: torch.Tensor, k_levels: int):
    """Per-bucket packed node counts and offsets after k pairwise levels."""
    c = lens.to(torch.int64)
    s = None
    for _ in range(k_levels):
        c = (c + 1) >> 1
        s = torch.cumsum(c, 0) - c
    return c, s


def build_level_map(
    s_prev: torch.Tensor,
    c_prev: torch.Tensor,
    s_k: torch.Tensor,
    c_k: torch.Tensor,
    t_cap: int,
) -> torch.Tensor:
    """(t_cap,) int32 level map: absolute childA | FLAG_SINGLE, or
    FLAG_INVALID past the level's real node count."""
    dev = s_k.device
    s_prev, c_prev, s_k, c_k = (
        v.to(torch.int64) for v in (s_prev, c_prev, s_k, c_k)
    )
    t_k = s_k[-1] + c_k[-1]
    off = s_prev - 2 * s_k
    delta = torch.cat([off[:1], off[1:] - off[:-1]])
    # buckets whose nodes start at or past t_cap touch no slot: drop them
    plane = torch.zeros(t_cap + 1, dtype=torch.int64, device=dev)
    plane.index_add_(0, s_k.clamp(max=t_cap), delta)
    iota = torch.arange(t_cap, dtype=torch.int64, device=dev)
    child_a = 2 * iota + torch.cumsum(plane[:t_cap], 0)
    last_slot = torch.where((c_prev & 1) == 1, s_k + c_k - 1, t_cap)
    singles = torch.zeros(t_cap + 1, dtype=torch.int64, device=dev)
    singles.index_fill_(0, last_slot.clamp(max=t_cap), FLAG_SINGLE)
    return torch.where(
        iota < t_k, child_a | singles[:t_cap], FLAG_INVALID
    ).to(torch.int32)


def num_levels(max_len: int) -> int:
    """Levels until every bucket is a single node: ceil(log2(max_len))."""
    return max(1, int(np.ceil(np.log2(max(int(max_len), 2)))))


class TreePlan(NamedTuple):
    level_map1: torch.Tensor  # (T1 cap,) level-1 map into the sorted stream
    lens: torch.Tensor  # (B_e,) phantom-extended bucket lengths
    max_len: torch.Tensor  # () longest real bucket, on the device


def build_tree_plan(
    starts: torch.Tensor, lens: torch.Tensor, kn: int, num_windows: int
) -> TreePlan:
    """The pure tree's plan: the level-1 map and the longest real bucket,
    which picks the level count (num_levels)."""
    starts_e, lens_e = extend_with_phantom(starts, lens, kn, num_windows)
    c1, s1 = chain_counts(lens_e, 1)
    (t1_cap,) = level_caps(kn, lens_e.shape[0], 1)
    map1 = build_level_map(starts_e, lens_e, s1, c1, t1_cap)
    return TreePlan(level_map1=map1, lens=lens_e, max_len=lens.max())


class HybridPlan(NamedTuple):
    level_map1: torch.Tensor  # (T1 cap,) level-1 map into the sorted stream
    lens: torch.Tensor  # (B_e,) phantom-extended bucket lengths
    layout: StreamLayout  # finish layout over (S_K, c_K), real buckets
    finish: FinishPlan  # the finish's pieces over the layout


def build_hybrid_plan(
    starts: torch.Tensor,
    lens: torch.Tensor,
    kn: int,
    k_levels: int,
    num_windows: int,
) -> HybridPlan:
    starts_e, lens_e = extend_with_phantom(starts, lens, kn, num_windows)
    c1, s1 = chain_counts(lens_e, 1)
    (t1_cap,) = level_caps(kn, lens_e.shape[0], 1)
    map1 = build_level_map(starts_e, lens_e, s1, c1, t1_cap)
    c_k, s_k = chain_counts(lens_e, k_levels)
    layout = build_stream_layout(
        real_bucket_view(s_k, num_windows),
        real_bucket_view(c_k, num_windows),
        num_windows,
    )
    t_k = level_caps(kn, lens_e.shape[0], k_levels)[-1]
    return HybridPlan(level_map1=map1, lens=lens_e, layout=layout,
                      finish=finish_plan(layout.starts_rk, layout.lens_rk,
                                         t_k))


# ---------------------------------------------------------------------------
# Kernel 2: one tree level
# ---------------------------------------------------------------------------


def tree_level_plain(
    arr_in, level_map, mode: str, last: bool, sorted_vals=None, group=G1,
    rows: bool = False,
) -> torch.Tensor:
    """Plain form of kernel 2 (same arguments as run_tree_level)."""
    m = level_map.to(torch.int64)
    invalid = (m & FLAG_INVALID) != 0
    single = (m & FLAG_SINGLE) != 0
    a = torch.where(invalid, 0, m & CHILD_MASK)
    # a pair's second child exists; for others read A twice (unused)
    b = torch.where(invalid | single, a, a + 1)
    if mode == "aff":
        aff_a = signed_rows(arr_in, sorted_vals, a, group)
        aff_b = signed_rows(arr_in, sorted_vals, b, group)
        res = group.add_affine_lazy(aff_a, aff_b)
        alt = group.from_affine(aff_a)
    else:
        pa = group.split(arr_in[:, a])
        res = group.add_lazy(pa, group.split(arr_in[:, b]))
        alt = pa
    out = group.select(single, alt, res)
    out = group.select(invalid, group.zero(m.shape[0], m.device), out)
    if last:
        out = group.canon(out)
    return node_rows(C.merge(out), group) if rows else C.merge(out)


def run_tree_level(
    arr_in: torch.Tensor,
    level_map: torch.Tensor,
    mode: str,
    last: bool = False,
    sorted_vals: torch.Tensor | None = None,
    group=G1,
    rows: bool = False,
) -> torch.Tensor:
    """One tree level -> (39|36, len(level_map)) packed lazy node plane,
    or with rows its (len(level_map), node_words) node rows (the layout
    the finish reads).

    mode "aff": arr_in is the (2N, 32) row-major signed table and
    sorted_vals the sorted entry stream the map points into.  mode "full":
    arr_in is the previous level's (39|36, T) plane.  last canonicalizes
    the outputs (a plane only)."""
    if last and rows:
        raise ValueError("node rows hold lazy nodes: last and rows exclude "
                         "each other")
    t_out = level_map.shape[0]
    if mode == "aff":
        n_points = check_signed_table(arr_in)
        ops = (arr_in, level_map, sorted_vals)
    elif mode == "full":
        check_plane(arr_in, group.rows)
        ops = (arr_in, level_map)
    else:
        raise ValueError(f"unknown tree level mode {mode!r}")
    if not on_cuda(*ops):
        return tree_level_plain(arr_in, level_map, mode, last, sorted_vals,
                                group, rows)
    shape = (t_out, node_words(group)) if rows else (group.rows, t_out)
    out = torch.empty(shape, dtype=torch.int32, device=arr_in.device)
    # csrc/tree.cu out modes: 0 lazy plane, 1 canonical plane, 2 node rows
    out_mode = 2 if rows else int(last)
    tag = group.ctx.tag
    if mode == "aff":
        launch("tree" + tag, "msm_tree_level_aff", "tree_level_aff" + tag,
               t_out, arr_in.data_ptr(), n_points, sorted_vals.data_ptr(),
               level_map.data_ptr(), out.data_ptr(), t_out, out_mode,
               device=out.device)
    else:
        launch("tree" + tag, "msm_tree_level_full", "tree_level_full" + tag,
               t_out, arr_in.data_ptr(), arr_in.shape[1], level_map.data_ptr(),
               out.data_ptr(), t_out, out_mode, device=out.device)
    return out


def _tree_levels(tree_table, sorted_vals, level_map1, lens, levels, canon,
                 group, rows=False):
    """Tree levels 1..levels over the phantom-extended lens; canon
    canonicalizes the last level, rows writes it as node rows.  Returns
    (the last level, packed offsets S_levels)."""
    kn = sorted_vals.shape[0]
    caps = level_caps(kn, lens.shape[0], levels)
    lvl = run_tree_level(tree_table, level_map1, "aff",
                         last=canon and levels == 1, sorted_vals=sorted_vals,
                         group=group, rows=rows and levels == 1)
    c_prev, s_prev = chain_counts(lens, 1)
    for k in range(2, levels + 1):
        c_k = (c_prev + 1) >> 1
        s_k = torch.cumsum(c_k, 0) - c_k
        level_map = build_level_map(s_prev, c_prev, s_k, c_k, caps[k - 1])
        lvl = run_tree_level(lvl, level_map, "full",
                             last=canon and k == levels, group=group,
                             rows=rows and k == levels)
        c_prev, s_prev = c_k, s_k
    return lvl, s_prev


def tree_smvp_hybrid(
    tree_table: torch.Tensor,
    sorted_vals: torch.Tensor,
    plan: HybridPlan,
    k_levels: int,
    group=G1,
) -> torch.Tensor:
    """Tree levels 1..k_levels, the last written as node rows, then the
    packed finish.  Returns the (39|36, B) block-ordered canonical bucket
    plane (one column per real bucket, length-sorted rank order; see
    permute_buckets)."""
    lvl, _ = _tree_levels(tree_table, sorted_vals, plan.level_map1, plan.lens,
                          k_levels, canon=False, group=group, rows=True)
    return packed_finish(lvl, plan.layout, group, plan.finish)


def tree_smvp(
    tree_table: torch.Tensor,
    sorted_vals: torch.Tensor,
    plan: TreePlan,
    levels: int,
    group=G1,
):
    """The pure tree: levels >= num_levels(longest bucket) pairwise levels,
    the last canonical.  Returns (final, s_fin): the (39|36, T) packed plane
    and the (B_e,) column of each bucket's sum in it (valid where the
    bucket is not empty; phantom-extended, see real_bucket_view)."""
    return _tree_levels(tree_table, sorted_vals, plan.level_map1, plan.lens,
                        levels, canon=True, group=group)


def permute_tree(
    final: torch.Tensor, s_fin: torch.Tensor, lens: torch.Tensor, order=None,
    group=G1,
) -> torch.Tensor:
    """Packed tree output -> window-major buckets, or buckets[order] when
    order (e.g. ops/bpr.py:bpr_order) is given: one column gather of the
    real buckets' s_fin / lens.  Empty buckets become the group's
    identity."""
    mask = lens > 0
    idx = torch.where(mask, s_fin.to(torch.int64), 0)
    if order is not None:
        o = torch.as_tensor(order, device=idx.device).reshape(-1).to(torch.int64)
        idx, mask = idx[o], mask[o]
    zero = group.zero(1, final.device)
    return C.merge(group.select(mask, group.split(final[:, idx]), zero))
