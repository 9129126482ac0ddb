#!/usr/bin/env python3
"""Times of the hybrid finish (TPU kernel row 4: ops/smvp_stream.py
packed_finish) of the PyTorch/CUDA port on one GPU, for a checkout given
by --root (default: this one), so that two commits can be compared on one
card in one call (run parent, change, change, parent).

    python3 tools/finish_times.py [--root DIR] [--label NAME]
                                  [--pieces 32,48,64] [--lone 4,16]

Both curves, each on the output of the hybrid tree's two levels:
  - uniform: the 2^20 bench case of DIR's chip_smoke.py (chunk 16), where
    no bucket is longer than a piece;
  - uniform_24: the shape of a uniform 2^24 MSM's finish (chunk 16: 16
    windows of 2^15 buckets, each of ceil(ceil(k / 2) / 2) level-2 nodes
    for k ~ Poisson(512) entries, ~128 nodes and 3 pieces of 48, but the
    top window's TOP_BUCKETS digits of ~3,510 entries, ~878 nodes and 19
    pieces), its node rows the uniform case's repeated, every bucket cut;
  - zipf: 2^18 points (the 2^18 bench case's) with the scalars of the
    benchmark's zipf_2p18 traffic (msm_bench/gen/zipf.py, seed 7; chunk
    15), whose top ranks put ~16,600 level-2 nodes in one bucket a
    window.
For each: the whole finish (every launch of one packed_finish call, the
plan built beforehand where the checkout plans it with the levels), CUDA
events around each call after a synchronize, median of 5 after a warm
call; and from torch.profiler over 5 more calls each kernel's device time
a call (the piece pass packed_finish_kernel, the fold
fold_pieces_kernel).  Where the checkout cuts buckets into pieces
(smvp_stream.finish_plan), also: the plan's longest piece, pieces of the
most cut bucket and buckets cut, and the same times with each piece
length of --pieces (not on uniform_24).  Where the checkout's fold folds
short slots on one thread (smvp_stream.FOLD_LONE): the fold's registers
(ptxas), and with --lone the fold's device time on uniform_24 and zipf
with smvp_stream.FOLD_LONE set to each count of the list (at most
tree.cu's FOLD_LONE_MAX).  Prints the card (nvidia-smi name and power
limit) and one JSON line; writes nothing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


#: digits of the top window at chunk 16 (bits 240 and up of a scalar below
#: the BLS12-377 group order r: r >> 240 = 4,779, and digit 0)
TOP_BUCKETS = 4780


def fold_regs(path: Path) -> dict:
    """{fold kernel: its ptxas "Used ... registers" line} of a build log."""
    out, kernel = {}, None
    for line in path.read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and "Used" in line and "registers" in line:
            if "fold_pieces_kernel" in kernel:
                out[kernel] = line.split(":", 1)[-1].strip()
            kernel = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--pieces", default="32,48,64")
    ap.add_argument("--lone", default="")
    opts = ap.parse_args()
    root = opts.root or __file__.rsplit("/tools/", 1)[0]
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("finish_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from msm_bench.gen import zipf
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import words_to_device
    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_tree as T
    from webgpu_msm_bls12_377_tpu_torch.ops.buckets import build_bucket_plan
    from webgpu_msm_bls12_377_tpu_torch.ops.convert import WireLayout
    from webgpu_msm_bls12_377_tpu_torch.ops.decompose import (
        decompose_scalars_signed,
        num_windows_for,
    )

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cut = hasattr(S, "finish_plan")
    lone = hasattr(S, "FOLD_LONE")
    sweep = [int(x) for x in opts.lone.split(",") if x] if lone else []

    def fold_sweep(fn):
        # the fold's device time at each lone count of --lone
        if not sweep:
            return {}
        kept, got = S.FOLD_LONE, {}
        try:
            for k in sweep:
                S.FOLD_LONE = k
                got[f"lone{k}"] = fold_ms(device_ms(fn))
        finally:
            S.FOLD_LONE = kept
        return got

    def kernel_ms(fn, reps=5):
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            out.append(round(e0.elapsed_time(e1), 4))
        return statistics.median(out), out

    def device_ms(fn, calls=5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return {e.key.split("(")[0].split(" ")[-1]:
                round(e.self_device_time_total / calls / 1e3, 4)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}

    def level2(pw, sw, chunk, group):
        table = K.point_prep(
            words_to_device(pw, dev),
            WireLayout.of(pw, False, group.ctx.nw - 1, 2), group, K.SIGNED)
        windows = num_windows_for(chunk)
        swd = torch.from_numpy(np.ascontiguousarray(sw).view("int32")).to(dev)
        plan = build_bucket_plan(decompose_scalars_signed(swd, chunk, windows),
                                 chunk)
        kn = plan.sorted_vals.shape[0]
        hp = T.build_hybrid_plan(plan.starts, plan.lens, kn, 2, windows)
        lvl1 = T.run_tree_level(table, hp.level_map1, "aff", False,
                                plan.sorted_vals, group)
        c1, s1 = T.chain_counts(hp.lens, 1)
        c2, s2 = T.chain_counts(hp.lens, 2)
        cap2 = T.level_caps(kn, hp.lens.shape[0], 2)[1]
        map2 = T.build_level_map(s1, c1, s2, c2, cap2)
        return T.run_tree_level(lvl1, map2, "full", group=group, rows=True), hp

    def shape_2p24(rows, seed=24):
        # 16 windows of 2^15 buckets, each bucket's entries ~ Poisson(512)
        # but in the top window, where a scalar below the group order
        # leaves TOP_BUCKETS digits, each ~ Poisson(2^24 / TOP_BUCKETS);
        # halved twice by the levels; disjoint segments in window-major
        # order over the rows given, repeated as far as they need
        gen = torch.Generator(device=dev).manual_seed(seed)
        mean = torch.full((16, 2**15), 512.0, device=dev)
        mean[15] = 0.0
        mean[15, :TOP_BUCKETS] = 2**24 / TOP_BUCKETS
        k = torch.poisson(mean.flatten(), gen)
        lens = ((k.to(torch.int64) + 1) // 2 + 1) // 2
        starts = torch.cumsum(lens, 0) - lens
        total = int(lens.sum())
        reps = -(-total // rows.shape[0])
        big = rows.repeat(reps, 1)[:total].contiguous()
        layout = S.build_stream_layout(starts.to(torch.int32),
                                       lens.to(torch.int32), 16)
        return big, layout, S.finish_plan(layout.starts_rk, layout.lens_rk,
                                          total)

    def fold_ms(dev_ms):
        return sum(v for k, v in dev_ms.items() if "fold_pieces_kernel" in k)

    traffic = json.loads((Path(root) / "msm_bench" / "traffic"
                          / "zipf_2p18.json").read_text())
    res = {"label": opts.label, "cut": cut, "lone": lone}
    if lone:
        res["fold_regs"] = {tag: fold_regs(K._build_dir() / f"tree{tag}.log")
                            for tag in ("", "_ed")}
    for curve, group, tag in (("bls12_377", C.G1, ""),
                              ("edwards_bls12", C.EDWARDS, "_ed")):
        cases = {}
        pw, sw, _ = cs.bench_case(20, curve)
        cases["uniform_20"] = (pw, sw, 16)
        pw18, _, _ = cs.bench_case(18, curve)
        config = {"scalar_bits": 253}
        zsw = zipf.scalar_sets(dict(traffic, pool_sets=1), config, 7)[0]
        cases["zipf_18"] = (pw18, zsw.T, 15)
        for case, (pw, sw, chunk) in cases.items():
            key = f"{case}{tag}"
            rows, hp = level2(pw, sw, chunk, group)
            plan = getattr(hp, "finish", None)
            args = (rows, hp.layout, group) + ((plan,) if plan is not None
                                                else ())
            res[f"finish_{key}"] = kernel_ms(lambda: S.packed_finish(*args))
            res[f"device_{key}"] = device_ms(lambda: S.packed_finish(*args))
            res[f"chain_max_{key}"] = int(hp.layout.lens_rk.max())
            if cut:
                for piece in (int(p) for p in opts.pieces.split(",")):
                    fp = S.finish_plan(hp.layout.starts_rk, hp.layout.lens_rk,
                                       rows.shape[0], piece)
                    res[f"plan_{key}_p{piece}"] = {
                        "longest_piece": int(fp.lens.max()),
                        "most_pieces": int(fp.counts.max()),
                        "cut": int(fp.n_split)}
                    res[f"finish_{key}_p{piece}"] = kernel_ms(
                        lambda: S.packed_finish(rows, hp.layout, group, fp))
                    res[f"device_{key}_p{piece}"] = device_ms(
                        lambda: S.packed_finish(rows, hp.layout, group, fp))
            if case == "uniform_20" and cut:
                big, lay, fp = shape_2p24(rows)
                k24 = f"uniform_24{tag}"
                res[f"plan_{k24}"] = {"rows": big.shape[0],
                                      "most_pieces": int(fp.counts.max()),
                                      "cut": int(fp.n_split)}
                res[f"finish_{k24}"] = kernel_ms(
                    lambda: S.packed_finish(big, lay, group, fp))
                res[f"device_{k24}"] = device_ms(
                    lambda: S.packed_finish(big, lay, group, fp))
                for v, ms in fold_sweep(
                        lambda: S.packed_finish(big, lay, group, fp)).items():
                    res[f"fold_{k24}_{v}"] = ms
                del big, lay, fp
            if case == "zipf_18":
                for v, ms in fold_sweep(
                        lambda: S.packed_finish(*args)).items():
                    res[f"fold_{key}_{v}"] = ms
            del rows, hp, plan, args
            torch.cuda.empty_cache()
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
