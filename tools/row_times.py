#!/usr/bin/env python3
"""Times of TPU kernel rows 2, 9 and 10 of the PyTorch/CUDA port on one GPU,
for a checkout given by --root (default: this one), so that two commits can
be compared on one card in one call (run parent, change, change, parent).

    python3 tools/row_times.py [--root DIR] [--label NAME]

On the bench cases of DIR's chip_smoke.py (bench_case), both curves:
  - row 2, tree level 1 (run_tree_level "aff") at 2^20 (chunk 16, the
    hybrid plan's level map);
  - row 9, the stream kernel (accumulate_buckets_streamed) at 2^17
    (chunk 15);
  - row 10, the fused path's bucket sums (accumulate_buckets_fused, the
    engine's kernel-8 stage) at the 2^14 and 2^10 defaults (chunk 4), for
    PIECE = 8, 16 and 32 where the function takes a piece length;
  - warm compute_msm / compute_msm_edwards at 2^14 and 2^10 (host clock,
    fenced), median of 3.
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
        mont_point_table,
        words_to_device,
    )
    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
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

    fused_takes = set(inspect.signature(SK.accumulate_buckets_fused).parameters)
    res = {"label": opts.label, "card": smi}
    for curve, group, tag in (("bls12_377", C.G1, ""),
                              ("edwards_bls12", C.EDWARDS, "_ed")):
        # row 2: level 1 at 2^20
        _, _, table, plan, windows = prepared(20, 16, curve, group)
        kn = plan.sorted_vals.shape[0]
        hp = T.build_hybrid_plan(plan.starts, plan.lens, kn, 2, windows)
        signed = S.build_signed_table(table, group)
        res[f"row2{tag}"] = kernel_ms(lambda: T.run_tree_level(
            signed, hp.level_map1, "aff", False, plan.sorted_vals, group), 5)
        del signed, hp, table, plan
        # row 9: the stream kernel at 2^17
        _, _, table, plan, windows = prepared(17, 15, curve, group)
        signed = S.build_signed_table(table, group)
        layout = S.build_stream_layout(plan.starts, plan.lens, windows)
        res[f"row9{tag}"] = kernel_ms(lambda: S.accumulate_buckets_streamed(
            signed, plan.sorted_vals, layout, group), 5)
        del signed, table, plan
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
            warm = []
            run(pw, sw)
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(pw, sw)
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t0)
            res[f"msm{tag}_{power}"] = (statistics.median(warm), warm)
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
