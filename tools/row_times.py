#!/usr/bin/env python3
"""Times of TPU kernel rows 2-5, 9 and 10 of the PyTorch/CUDA port on one
GPU, for a checkout given by --root (default: this one), so that two
commits can be compared on one card in one call (run parent, change,
change, parent).

    python3 tools/row_times.py [--root DIR] [--label NAME] [--skip-fused]

On the bench cases of DIR's chip_smoke.py (bench_case), both curves:
  - row 2, tree level 1 (run_tree_level "aff") at 2^20 (chunk 16, the
    hybrid plan's level map);
  - row 3, tree level 2 (run_tree_level "full", the hybrid's last level:
    node rows where the checkout writes them), and row 4, the hybrid
    finish (packed_finish) on its output, at 2^20, in the plan's layout
    and, where the checkout's finish takes node rows, also in natural
    (window-major) order; the plan's per-window length sort
    (build_stream_layout) on the same segments; the whole hybrid SMVP
    (tree_smvp_hybrid);
  - row 5, BPR stage 1 on the real bucket plane in walk order at 2^20
    (the tree's) and 2^17 (the stream path's, chunk 15): the checkout's
    form (bpt - 1 launches of bpr_running_add, or one bpr_stage1 launch
    for split 1, 2, 4 and 8), and the whole reduce_buckets_prearranged;
  - warm compute_msm / compute_msm_edwards at 2^20 with CuzkMsmEngine's
    default (hybrid, tree_finish 2), tree_finish 3 and 4 and the pure
    tree (smvp_mode "tree"), median of 3;
  - row 9, the stream kernel (accumulate_buckets_streamed) at 2^17
    (chunk 15);
  - row 10, the fused path's bucket sums (accumulate_buckets_fused, the
    engine's kernel-8 stage) at the 2^14 and 2^10 defaults (chunk 4), for
    PIECE = 8, 16 and 32 where the function takes a piece length;
  - warm compute_msm / compute_msm_edwards at 2^14 and 2^10 (host clock,
    fenced), median of 3 (left out with --skip-fused, as is row 10).
Kernel times are medians of 5 launches (3 for row 10) on the same
operands, CUDA events around each after a synchronize.  Prints the card
(nvidia-smi name and power limit) and one JSON line; writes nothing else.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--skip-fused", action="store_true")
    opts = ap.parse_args()
    root = opts.root or __file__.rsplit("/tools/", 1)[0]
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("row_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from webgpu_msm_bls12_377_tpu_torch import compute_msm, compute_msm_edwards
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import (
        CuzkMsmEngine,
        mont_point_table,
        words_to_device,
    )
    from webgpu_msm_bls12_377_tpu_torch.ops import bpr
    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_tree as T
    from webgpu_msm_bls12_377_tpu_torch.ops.buckets import build_bucket_plan
    from webgpu_msm_bls12_377_tpu_torch.ops.decompose import (
        decompose_scalars_signed,
        num_windows_for,
    )

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def kernel_ms(fn, reps):
        fn()  # warm: build, allocator
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            out.append(e0.elapsed_time(e1))
        return statistics.median(out), out

    def prepared(power, chunk, curve, group):
        pw, sw, _ = cs.bench_case(power, curve)
        table = mont_point_table(words_to_device(pw, dev), group)
        windows = num_windows_for(chunk)
        swd = torch.from_numpy(sw.view("int32")).to(dev)
        plan = build_bucket_plan(decompose_scalars_signed(swd, chunk, windows),
                                 chunk)
        return pw, sw, table, plan, windows

    def takes(fn):
        return set(inspect.signature(fn).parameters)

    def warm_msm(run, pw, sw):
        run(pw, sw)
        warm = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(pw, sw)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        return statistics.median(warm), warm

    def stage1_times(buckets, windows, chunk, group, key):
        """Row 5 on one bucket plane in BPR walk order: the checkout's
        stage 1 and its whole reduction."""
        threads = 512
        bpt = (1 << (chunk - 1)) // threads
        lanes = windows * threads
        if hasattr(K, "bpr_stage1"):
            for split in (1, 2, 4, 8):
                res[f"{key}_split{split}"] = kernel_ms(
                    lambda: K.bpr_stage1(buckets, bpt, split, group), 5)
        else:
            steps = buckets.reshape(group.rows, bpt, lanes).permute(1, 0, 2)
            steps = steps.contiguous()

            def walk():
                m = g = steps[0]
                for st in range(1, bpt):
                    m, g = K.bpr_running_add(m, g, steps[st], group)
            res[key] = kernel_ms(walk, 5)
        res[f"{key}_bpr"] = kernel_ms(lambda: bpr.reduce_buckets_prearranged(
            buckets, windows, chunk, threads, group), 5)

    fused_takes = takes(SK.accumulate_buckets_fused)
    rows_kw = {"rows": True} if "rows" in takes(T._tree_levels) else {}
    res = {"label": opts.label, "card": smi}
    for curve, group, tag in (("bls12_377", C.G1, ""),
                              ("edwards_bls12", C.EDWARDS, "_ed")):
        # row 2: level 1 at 2^20
        pw, sw, table, plan, windows = prepared(20, 16, curve, group)
        kn = plan.sorted_vals.shape[0]
        hp = T.build_hybrid_plan(plan.starts, plan.lens, kn, 2, windows)
        signed = S.build_signed_table(table, group)
        res[f"row2{tag}"] = kernel_ms(lambda: T.run_tree_level(
            signed, hp.level_map1, "aff", False, plan.sorted_vals, group), 5)
        # rows 3 and 4: level 2 (the last) and the finish on its output
        lvl1 = T.run_tree_level(signed, hp.level_map1, "aff", False,
                                plan.sorted_vals, group)
        c1, s1 = T.chain_counts(hp.lens, 1)
        c2, s2 = T.chain_counts(hp.lens, 2)
        cap2 = T.level_caps(kn, hp.lens.shape[0], 2)[1]
        map2 = T.build_level_map(s1, c1, s2, c2, cap2)
        res[f"row3{tag}"] = kernel_ms(lambda: T.run_tree_level(
            lvl1, map2, "full", group=group, **rows_kw), 5)
        lvl2 = T.run_tree_level(lvl1, map2, "full", group=group, **rows_kw)
        del lvl1
        starts = T.real_bucket_view(s2, windows).to(torch.int32)
        lens = T.real_bucket_view(c2, windows).to(torch.int32)
        layouts = {"plan": hp.layout}
        if rows_kw:
            layouts["natural"] = S.StreamLayout(
                starts, lens, torch.arange(lens.shape[0], dtype=torch.int32,
                                           device=dev))
        for name, layout in layouts.items():
            res[f"row4{tag}_{name}"] = kernel_ms(
                lambda: S.packed_finish(lvl2, layout, group), 5)
        res[f"sort{tag}"] = kernel_ms(
            lambda: S.build_stream_layout(starts, lens, windows), 5)
        res[f"smvp{tag}_20"] = kernel_ms(lambda: T.tree_smvp_hybrid(
            signed, plan.sorted_vals, hp, 2, group), 5)
        # row 5 at 2^20 on the tree's buckets in walk order
        order = bpr.bpr_order_on(windows, 16, 512, dev)
        blocks = T.tree_smvp_hybrid(signed, plan.sorted_vals, hp, 2, group)
        buckets = S.permute_buckets(blocks, hp.layout, order=order,
                                    group=group)
        del lvl2, blocks
        stage1_times(buckets, windows, 16, group, f"row5{tag}_20")
        del signed, hp, table, plan, buckets
        # the tree_finish yardstick: warm MSMs at 2^20
        for name, opts_ in (("k2", {}), ("k3", {"tree_finish": 3}),
                            ("k4", {"tree_finish": 4}),
                            ("pure", {"smvp_mode": "tree"})):
            eng = CuzkMsmEngine(group.CURVE, **opts_)
            res[f"msm{tag}_20_{name}"] = warm_msm(eng.compute_msm, pw, sw)
        del pw, sw
        # row 9: the stream kernel at 2^17
        _, _, table, plan, windows = prepared(17, 15, curve, group)
        signed = S.build_signed_table(table, group)
        layout = S.build_stream_layout(plan.starts, plan.lens, windows)
        res[f"row9{tag}"] = kernel_ms(lambda: S.accumulate_buckets_streamed(
            signed, plan.sorted_vals, layout, group), 5)
        # row 5 at 2^17 on the stream path's buckets in walk order
        blocks = S.accumulate_buckets_streamed(signed, plan.sorted_vals,
                                               layout, group)
        buckets = S.permute_buckets(
            blocks, layout, order=bpr.bpr_order_on(windows, 15, 512, dev),
            group=group)
        stage1_times(buckets, windows, 15, group, f"row5{tag}_17")
        del signed, table, plan, blocks, buckets
        if opts.skip_fused:
            continue
        # row 10: the fused bucket sums at the chunk-4 defaults, and the
        # whole warm MSM
        run = compute_msm if group is C.G1 else compute_msm_edwards
        for power in (14, 10):
            pw, sw, table, plan, _ = prepared(power, 4, curve, group)
            gathered = SK.pregather_signed(SK.make_wide_rows(table, group),
                                           plan.sorted_vals, group)
            n = 1 << power
            pieces = (8, 16, 32) if "piece" in fused_takes else (None,)
            for piece in pieces:
                kw = {} if piece is None else {"piece": piece, "max_len": n}
                key = f"row10{tag}_{power}" + ("" if piece is None
                                               else f"_piece{piece}")
                res[key] = kernel_ms(lambda: SK.accumulate_buckets_fused(
                    gathered, plan.starts, plan.lens, group, **kw), 3)
            res[f"msm{tag}_{power}"] = warm_msm(run, pw, sw)
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
