#!/usr/bin/env python3
"""Times of TPU kernel rows 2-5, 9 and 10 and the fused path's fold (with
--bpr: rows 1 and 5-8; with --prep: row 1's point prep and the copy; with
--baseline: rows 11 and 12a-c) of the PyTorch/CUDA port on one GPU, for
a checkout given by --root (default: this one), so that two commits can
be compared on one card in one call (run parent, change, change, parent).

    python3 tools/row_times.py [--root DIR] [--label NAME] [--skip-fused]
                               [--skip-tail] [--variants]
    python3 tools/row_times.py --bpr [--root DIR] [--label NAME] [--variants]
    python3 tools/row_times.py --prep [--root DIR] [--label NAME] [--variants]
    python3 tools/row_times.py --baseline [--root DIR] [--label NAME]
                               [--variants]
    python3 tools/row_times.py --sass

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
    (chunk 15), and the warm compute_msm / compute_msm_edwards there,
    median of 3;
  - row 10, the fused path's bucket sums (accumulate_buckets_fused, the
    engine's kernel-8 stage) at the 2^14 and 2^10 defaults (chunk 4), for
    PIECE = 8, 16 and 32 where the function takes a piece length;
  - warm compute_msm / compute_msm_edwards at 2^14 and 2^10 (host clock,
    fenced), median of 3 (left out with --skip-fused, as is row 10);
  - the fold (smvp_kernel.fold_pieces: the checkout's level launches or
    its one launch) on kernel 8's piece sums at the 2^14 and 2^10
    defaults, and on a duplicate-heavy 2^16 case at chunk 15 (nine in ten
    scalars equal: each window's largest bucket holds ~59,000 entries,
    ~1,840 pieces), the pieces planned as one dispatch;
  - with --skip-tail, rows 4 and 5, the split sweep and the tree_finish
    yardstick (but its default, k2) are left out.
With --variants (a checkout whose tree.cu and stream.cu take the macros
below), tree.cu and stream.cu are also built with each of VARIANTS'
flags (the C-form product; the register budget of 2, 3 and 4 blocks a SM)
(ops/kernels.py:build_variants, which --root's checkout must have) into
variants/<key>/<sources>/<variant>/ of the build root ($MSM_BUILD_DIR,
else build/), and rows 2, 3, 9
and the folds are timed again with each variant's libraries in place of
the default build's; each library's ptxas registers and spills of the
full level, the fold and the stream kernel are reported as
regs_<variant>_<library>.
Kernel times are medians of 5 launches (3 for row 10) on the same
operands, CUDA events around each after a synchronize.  Prints the card
(nvidia-smi name and power limit) and one JSON line; writes nothing else
but the variant builds.

--bpr times only kernel 1 and BPR (rows 1 and 5-8), both curves:
  - row 1 / 1e, kernel 1 on the operands of its launches in one
    compute_msm at 2^20 (the point prep, point_prep, where the checkout
    has it, else mont_mul_const's entry into the Montgomery domain and,
    for Edwards, mont_mul_lanes; and the window sums' exit,
    mont_mul_const), each after one untimed launch, median of five; and,
    from torch.profiler over five more launches, the kernel's and the
    host-to-device copies' device time a launch;
  - on the bucket plane that one compute_msm hands reduce_buckets_prearranged
    at 2^20 (chunk 16, the tree), 2^17 (chunk 15, the stream path) and 2^14
    (chunk 4, T = 8, the fused path): row 5, stage 1 at the engine's split;
    rows 6-7, stage 2, and row 8, the fold, through the checkout's entry
    points (one launch each of bpr_stage2 and bpr_fold, or the older
    checkout's bpr_double and bpr_masked_add_double launches and its
    gathers with bpr_add launches, told apart with hasattr), each also with
    the kernels' device time a call from torch.profiler; and the whole
    reduce_buckets_prearranged;
  - with --variants, bpr.cu built with each of BPR_VARIANTS' flags (the C
    form; stage 1 at 2, 3 and 4 blocks a SM) and rows 5-8 timed again with
    each, with each library's ptxas registers and spills of stage 1,
    stage 2 and the fold.

--prep times row 1's point prep and the copy before it, both curves, at
2^20 and 2^17, on the bench case's word-major words and on its wire bytes
(point-major words, as the buffer holds them), medians of five:
  - the copy: the checkout's words_to_device (at each of --workers'
    STAGE_WORKERS where the checkout has it), and the unchunked staging in its three
    parts (the pinned buffer from the caching host allocator, the host
    fill, the device copy), fenced, host clock; from bytes also the host
    unpacking of earlier checkouts (points_buffer_to_words and
    scalars_buffer_to_words), where the checkout's engine calls them;
  - the table: the checkout's point prep on the copied words, CUDA events
    (point_prep in its SIGNED and PLANE forms from either layout where
    the checkout has it; else mont_point_table then build_signed_table
    on word-major words), and its device time a call and its kernels
    from torch.profiler;
  - the warm compute_msm / compute_msm_edwards at 2^20 from words and
    from bytes, host clock, fenced, median of five;
  - with --variants, convert.cu built with -DMSM_MONT_C (the C-form
    product) into build/variants/ and the point prep timed with it.

--baseline times the rows that only the baseline engines and the chain
reach, both curves, on the bench cases (chip_smoke.py's bench_case, whose
time at 2^16 and 2^14 is reported too):
  - row 11, the legacy SMVP with its BPR (CuzkMsmEngine's plan, sum and
    BPR of the legacy path; a parent's _smvp_legacy) on
    the operands of one PippengerMsmEngine call at 2^16 (chunk 15) and of
    one call forced through legacy at 2^14 (chunk 4); where the checkout
    sums buckets in one launch (legacy_buckets), also that launch over the
    engine's pieces and over whole buckets, and the fold of the pieces;
  - row 12a, the naive engine's scalar multiplication
    (batched_scalar_mult), and row 12b, its tree sum (tree_sum: a
    fused_add launch a level, or the one launch), on the operands of one
    NaiveMsmEngine call at 2^16;
  - row 12c, the running-sum chain at 2^16 (chip_smoke.py's
    running_sum_chain) on its operands: its eight fused_running_add
    launches, or its one running_sum launch over the walk;
  - one canonical add's latency: the checkout's one-add launch on one
    lane (fused_add, a lone thread's add; or the tree sum of two lanes,
    one cooperative add), and the running sum of one lane over 1, 2, 8
    and 16 steps (where the checkout has it), whose slope is a lone
    thread's two dependent adds a step: a tree of a thread an add is
    log2 N of them deep;
  - the warm PippengerMsmEngine and NaiveMsmEngine calls at 2^16 and the
    forced legacy call at 2^14, host clock, fenced, median of five (two
    for a checkout that runs the 2^14 legacy call in rounds);
  each kernel time with the profiler's device time a call;
  - with --variants, legacy.cu and canon.cu built with each of
    BASELINE_VARIANTS' flags (the C-form product; 1, 2 and 3 blocks a SM
    for the legacy SMVP, the scalar multiplication and the running sum)
    and the rows timed again with each, with each library's ptxas
    registers and spills.

--sass times nothing: for each field and each product form (the C form,
and -DMSM_MONT_CHAIN) it compiles SASS_KERNELS, which call
csrc/field.cuh's mont_mul once (one_mont_mul) and mont_mul_pair once
(one_mont_mul_pair), and csrc/curve.cuh's canonical add pt_add (one_pt_add)
and lazy full add pt_add_lazy (one_pt_add_lazy) once, into sm_90a cubins
under sass/ of the build root ($MSM_BUILD_DIR, else build/), disassembles
them with cuobjdump -sass and prints one JSON line of each kernel's
instruction count by opcode (the part before the first dot: IMAD,
IADD3, ...; the operands' loads and stores are in every count alike):
{form: {field: {kernel: {"total": n, opcode: n, ...}}}}.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: extra nvcc flags of each variant build of tree.cu and stream.cu
VARIANTS = {
    "c_form": ("-DMSM_MONT_C",),
    "blocks2": ("-DTREE_FULL_MIN_BLOCKS=2", "-DSTREAM_MIN_BLOCKS=2"),
    "blocks3": ("-DTREE_FULL_MIN_BLOCKS=3", "-DSTREAM_MIN_BLOCKS=3"),
    "blocks4": ("-DTREE_FULL_MIN_BLOCKS=4", "-DSTREAM_MIN_BLOCKS=4"),
}
VARIANT_SOURCES = ("tree", "stream")
#: --bpr --variants: extra nvcc flags of each variant build of bpr.cu
BPR_VARIANTS = {
    "c_form": ("-DMSM_MONT_C",),
    "blocks2": ("-DSTAGE1_MIN_BLOCKS=2",),
    "blocks3": ("-DSTAGE1_MIN_BLOCKS=3",),
    "blocks4": ("-DSTAGE1_MIN_BLOCKS=4",),
}

#: --prep --variants: extra nvcc flags of each variant build of convert.cu
PREP_VARIANTS = {"c_form": ("-DMSM_MONT_C",)}
#: --baseline --variants: extra nvcc flags of each variant build of
#: legacy.cu and canon.cu
BASELINE_VARIANTS = {
    "c_form": ("-DMSM_MONT_C",),
    **{f"blocks{b}": (f"-DLEGACY_MIN_BLOCKS={b}", f"-DCANON_MIN_BLOCKS={b}")
       for b in (1, 2, 3)},
}

#: --sass: one product of each kind, on its own
SASS_KERNELS = r"""
#include "curve.cuh"

__global__ void one_mont_mul(const u32* __restrict__ a,
                             const u32* __restrict__ b, u32* __restrict__ r) {
  u32 x[NW], y[NW], z[NW];
  for (int i = 0; i < NW; ++i) x[i] = a[i * 1024 + threadIdx.x];
  for (int i = 0; i < NW; ++i) y[i] = b[i * 1024 + threadIdx.x];
  mont_mul(z, x, y);
  for (int i = 0; i < NW; ++i) r[i * 1024 + threadIdx.x] = z[i];
}

__global__ void one_mont_mul_pair(const u32* __restrict__ a,
                                  const u32* __restrict__ b,
                                  u32* __restrict__ r) {
  u32 x[NW], y[NW], z[NW];
  for (int i = 0; i < NW; ++i) x[i] = a[i * 1024 + threadIdx.x];
  for (int i = 0; i < NW; ++i) y[i] = b[i * 1024 + threadIdx.x];
  mont_mul_pair(z, x, y, y, x);
  for (int i = 0; i < NW; ++i) r[i * 1024 + threadIdx.x] = z[i];
}

__global__ void one_pt_add(const int32_t* __restrict__ a,
                           int32_t* __restrict__ r) {
  Point x, y;
  pt_load(x, a, 2048, threadIdx.x);
  pt_load(y, a, 2048, threadIdx.x + 1024);
  pt_add(x, x, y);
  pt_store(r, 1024, threadIdx.x, x);
}

__global__ void one_pt_add_lazy(const int32_t* __restrict__ a,
                                int32_t* __restrict__ r) {
  Point x, y;
  pt_load(x, a, 2048, threadIdx.x);
  pt_load(y, a, 2048, threadIdx.x + 1024);
  pt_add_lazy(x, x, y);
  pt_store(r, 1024, threadIdx.x, x);
}
"""
#: SASS_KERNELS' names, a name before any that it contains
SASS_NAMES = ("one_mont_mul_pair", "one_mont_mul", "one_pt_add_lazy",
              "one_pt_add")


def sass_opcodes(sass: str) -> dict:
    """{kernel: {"total": n, opcode: n}} from cuobjdump -sass output."""
    out, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next(k for k in SASS_NAMES if k in m.group(1))
            current = out.setdefault(name, {"total": 0})
            continue
        m = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if current is not None and m:
            current[m.group(1)] = current.get(m.group(1), 0) + 1
            current["total"] += 1
    return out


def sass_dir(K) -> Path:
    """sass/ beside the kernels' build root (a checkout from before
    kernels_root: beside its BUILD_ROOT)."""
    root = K.kernels_root() if hasattr(K, "kernels_root") else K.BUILD_ROOT
    return root.parent / "sass"


def sass_counts(K) -> dict:
    """--sass: the SASS opcode counts of one product in each form and field,
    every nvcc started together."""
    out_dir = sass_dir(K)
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "one_product.cu"
    src.write_text(SASS_KERNELS)
    nvcc = K._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    builds = {}
    for form, fflags in (("c", ()), ("chain", ("-DMSM_MONT_CHAIN",))):
        for field, cflags in (("bls12_377", ()),
                              ("edwards_bls12", ("-DMSM_CURVE_ED",))):
            cubin = out_dir / f"one_product_{form}_{field}.cubin"
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-cubin", "-I", str(K.CSRC), *fflags,
                   *cflags, "-o", str(cubin), str(src)]
            builds[form, field] = cubin, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    res: dict = {}
    for (form, field), (cubin, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"sass build of {form} {field} failed:\n{log}")
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
        res.setdefault(form, {})[field] = sass_opcodes(sass)
    return res


#: ptxas_regs' kernels: (key, a part of the mangled name)
PTXAS_KERNELS = (("full", "tree_level_kernelILb0ELi2"), ("fold", "fold_pieces"),
                 ("stream", "stream_buckets"), ("stage1", "stage1_kernel"),
                 ("stage2", "stage2_kernel"), ("bpr_fold", "fold_kernel"),
                 ("legacy", "legacy_buckets_kernel"),
                 ("masked_add_mixed", "masked_add_mixed_kernel"),
                 ("scalar_mult", "scalar_mult_kernel"),
                 ("masked_add_and_double", "masked_add_and_double_kernel"),
                 ("fused_add", "fused_add_kernel"),
                 ("running_add", "fused_running_add_kernel"),
                 ("running_sum", "running_sum_kernel"),
                 ("tree_sum", "tree_sum_kernel"))


def ptxas_regs(log: str) -> dict:
    """{kernel: "<registers> regs, <spill stores> B spilled"} for the full
    levels, the fold and the stream kernel, and BPR stage 1, stage 2 and
    its fold, of one library's ptxas log."""
    out, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if kernel and m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if kernel and m:
            key = next((k for k, part in PTXAS_KERNELS if part in kernel),
                       None)
            if key:
                out[key] = f"{m.group(1)} regs, {spill} B spilled"
            kernel = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--skip-fused", action="store_true")
    ap.add_argument("--skip-tail", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--bpr", action="store_true")
    ap.add_argument("--prep", action="store_true")
    ap.add_argument("--baseline", action="store_true")
    ap.add_argument("--workers", default="1,2,4",
                    help="--prep: host threads of the staged copy to time")
    opts = ap.parse_args()
    root = opts.root or __file__.rsplit("/tools/", 1)[0]
    sys.path.insert(0, root)
    if opts.sass:
        from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K

        print(json.dumps(sass_counts(K)))
        return 0
    import numpy as np
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

    def prepared(power, chunk, curve, group, heavy=False):
        pw, sw, _ = cs.bench_case(power, curve)
        if heavy:
            # nine in ten scalars equal to the first: each window's bucket
            # of that digit holds most of its entries
            sw = sw.copy()
            keep = np.random.default_rng(16).random(sw.shape[-1]) < 0.9
            sw[..., keep] = sw[..., :1]
        if hasattr(K, "point_prep"):
            from webgpu_msm_bls12_377_tpu_torch.ops.convert import WireLayout

            table = K.point_prep(
                words_to_device(pw, dev),
                WireLayout.of(pw, False, group.ctx.nw - 1, 2), group, K.PLANE)
        else:
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

    if opts.bpr:
        return bpr_rows(opts, smi, kernel_ms)
    if opts.prep:
        return prep_rows(opts, smi, kernel_ms)
    if opts.baseline:
        return baseline_rows(opts, smi, kernel_ms)
    fused_takes = takes(SK.accumulate_buckets_fused)
    rows_kw = {"rows": True} if "rows" in takes(T._tree_levels) else {}
    res = {"label": opts.label, "card": smi}
    variants = {}
    if opts.variants:
        t0 = time.perf_counter()
        dirs = K.build_variants(VARIANT_SOURCES, VARIANTS)
        res["variant_build_s"] = time.perf_counter() - t0
        variants = {v: K.load_variant(d, VARIANT_SOURCES)
                    for v, d in dirs.items()}
        for v, d in dirs.items():
            for f in sorted(d.glob("*.log")):
                res[f"regs_{v}_{f.stem}"] = ptxas_regs(f.read_text())
    K._lib("tree")  # the checkout's own build
    for f in sorted(K._build_dir().glob("*.log")):
        if f.stem.startswith(VARIANT_SOURCES):
            res[f"regs_default_{f.stem}"] = ptxas_regs(f.read_text())

    def each_variant(key, fn, reps):
        """fn timed with the default build as `key`, then with each
        variant's libraries as `key`_<variant>."""
        res[key] = kernel_ms(fn, reps)
        for v, libs in variants.items():
            with K.using(libs):
                res[f"{key}_{v}"] = kernel_ms(fn, reps)

    def fold_times(power, chunk, curve, group, key, heavy=False):
        """The fold on kernel 8's piece sums of one case, planned as one
        dispatch."""
        pw, sw, table, plan, _ = prepared(power, chunk, curve, group, heavy)
        gathered = SK.pregather_signed(SK.make_wide_rows(table, group),
                                       plan.sorted_vals, group)
        n = 1 << power
        pp = SK.piece_plan(plan.starts, plan.lens, gathered.shape[0], n)
        sums = SK.fused_segments(gathered, pp.starts, pp.lens, group)
        del gathered
        res[f"{key}_pieces_max"] = int(pp.counts.max())
        each_variant(key, lambda: SK.fold_pieces(
            sums, pp.counts, pp.offsets, pp.caps, group), 5)
    for curve, group, tag in (("bls12_377", C.G1, ""),
                              ("edwards_bls12", C.EDWARDS, "_ed")):
        # row 2: level 1 at 2^20
        pw, sw, table, plan, windows = prepared(20, 16, curve, group)
        kn = plan.sorted_vals.shape[0]
        hp = T.build_hybrid_plan(plan.starts, plan.lens, kn, 2, windows)
        signed = S.build_signed_table(table, group)
        each_variant(f"row2{tag}", lambda: T.run_tree_level(
            signed, hp.level_map1, "aff", False, plan.sorted_vals, group), 5)
        # rows 3 and 4: level 2 (the last) and the finish on its output
        lvl1 = T.run_tree_level(signed, hp.level_map1, "aff", False,
                                plan.sorted_vals, group)
        c1, s1 = T.chain_counts(hp.lens, 1)
        c2, s2 = T.chain_counts(hp.lens, 2)
        cap2 = T.level_caps(kn, hp.lens.shape[0], 2)[1]
        map2 = T.build_level_map(s1, c1, s2, c2, cap2)
        each_variant(f"row3{tag}", lambda: T.run_tree_level(
            lvl1, map2, "full", group=group, **rows_kw), 5)
        lvl2 = T.run_tree_level(lvl1, map2, "full", group=group, **rows_kw)
        del lvl1
        run = compute_msm if group is C.G1 else compute_msm_edwards
        if not opts.skip_tail:
            starts = T.real_bucket_view(s2, windows).to(torch.int32)
            lens = T.real_bucket_view(c2, windows).to(torch.int32)
            layouts = {"plan": hp.layout}
            if rows_kw:
                layouts["natural"] = S.StreamLayout(
                    starts, lens, torch.arange(lens.shape[0],
                                               dtype=torch.int32, device=dev))
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
            del blocks
            stage1_times(buckets, windows, 16, group, f"row5{tag}_20")
            del buckets
        del lvl2, signed, hp, table, plan
        # the warm MSM at 2^20, and the tree_finish yardstick
        yardstick = (("k2", {}),) if opts.skip_tail else (
            ("k2", {}), ("k3", {"tree_finish": 3}), ("k4", {"tree_finish": 4}),
            ("pure", {"smvp_mode": "tree"}))
        for name, opts_ in yardstick:
            eng = CuzkMsmEngine(group.CURVE, **opts_)
            res[f"msm{tag}_20_{name}"] = warm_msm(eng.compute_msm, pw, sw)
        del pw, sw
        # row 9: the stream kernel at 2^17, and the warm MSM there
        pw, sw, table, plan, windows = prepared(17, 15, curve, group)
        signed = S.build_signed_table(table, group)
        layout = S.build_stream_layout(plan.starts, plan.lens, windows)
        each_variant(f"row9{tag}", lambda: S.accumulate_buckets_streamed(
            signed, plan.sorted_vals, layout, group), 5)
        res[f"msm{tag}_17"] = warm_msm(run, pw, sw)
        if not opts.skip_tail:
            # row 5 at 2^17 on the stream path's buckets in walk order
            blocks = S.accumulate_buckets_streamed(signed, plan.sorted_vals,
                                                   layout, group)
            buckets = S.permute_buckets(
                blocks, layout, order=bpr.bpr_order_on(windows, 15, 512, dev),
                group=group)
            stage1_times(buckets, windows, 15, group, f"row5{tag}_17")
            del blocks, buckets
        del signed, table, plan
        # the fused path's fold at the chunk-4 defaults and on the
        # duplicate-heavy case
        for power in (14, 10):
            fold_times(power, 4, curve, group, f"fold{tag}_{power}")
        fold_times(16, 15, curve, group, f"fold{tag}_16_heavy", heavy=True)
        if opts.skip_fused:
            continue
        # row 10: the fused bucket sums at the chunk-4 defaults, and the
        # whole warm MSM
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
            del gathered
            res[f"msm{tag}_{power}"] = warm_msm(run, pw, sw)
    print(smi)
    print(json.dumps(res))
    return 0


def device_us(fn, calls=5):
    """{device op: [us a call, launches a call]} from torch.profiler over
    `calls` calls of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: [e.self_device_time_total / calls, e.count / calls]
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def captured(fn, args, *names):
    """One fn(*args) with each (module or class, name) wrapped to keep its
    arguments: {name: [args, ...]} (a method's include its self)."""
    calls = {name: [] for _, name in names}
    saved = [(mod, name, getattr(mod, name)) for mod, name in names]

    def keep(name, real):
        def run(*a):
            calls[name].append(a)
            return real(*a)
        return run
    for mod, name, real in saved:
        setattr(mod, name, keep(name, real))
    try:
        fn(*args)
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    return calls


def legacy_smvp(eng, table, plan, chunk, num_windows):
    """The legacy SMVP with its BPR, as CuzkMsmEngine._msm_set runs it."""
    order = eng._bpr_order(num_windows, chunk, table.device)
    own = eng._plan_legacy(table, plan, chunk, num_windows)
    return eng._bpr(eng._buckets_legacy(table, plan, own, chunk, num_windows,
                                        order), chunk, num_windows)


def baseline_rows(opts, smi, kernel_ms) -> int:
    """--baseline: rows 11 and 12a-c (see the module docstring)."""
    import torch

    import chip_smoke as cs
    from webgpu_msm_bls12_377_tpu_torch.models import (
        CuzkMsmEngine,
        NaiveMsmEngine,
        PippengerMsmEngine,
        naive,
    )
    from webgpu_msm_bls12_377_tpu_torch.ops import buckets
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK
    from webgpu_msm_bls12_377_tpu_torch.params import CurveId

    res = {"label": opts.label, "card": smi}
    sources = ("legacy", "canon")
    variants = {}
    if opts.variants:
        t0 = time.perf_counter()
        dirs = K.build_variants(sources, BASELINE_VARIANTS)
        res["variant_build_s"] = time.perf_counter() - t0
        variants = {v: K.load_variant(d, sources) for v, d in dirs.items()}
        for v, d in dirs.items():
            for f in sorted(d.glob("*.log")):
                res[f"regs_{v}_{f.stem}"] = ptxas_regs(f.read_text())
    K._lib("canon")  # the checkout's own build
    for f in sorted(K._build_dir().glob("*.log")):
        if f.stem.startswith(sources):
            res[f"regs_default_{f.stem}"] = ptxas_regs(f.read_text())
    fresh = hasattr(K, "scalar_mult")  # the one-launch entries

    def timed(key, fn, reps=5, calls=5):
        """Events (median of reps after a warm call) and the profiler's
        device time a call; with variants, again on each variant build."""
        res[key] = kernel_ms(fn, reps)
        res[f"{key}_device_us"] = device_us(fn, calls)
        for v, libs in variants.items():
            with K.using(libs):
                res[f"{key}_{v}"] = kernel_ms(fn, reps)

    def add_latency(key, group, one):
        """One canonical add's latency: the one-add launch on one lane (a
        fused_add, or the tree sum of two lanes: one cooperative add) and,
        with running_sum, one lane's running sum over 1, 2, 8 and 16 steps
        (a lone thread's 2 dependent adds a step), profiler device time a
        call."""
        # random coordinates below p (their top two words zero): the
        # add's work does not depend on them
        nw = group.ctx.nw
        pts = torch.randint(0, 1 << 31, (group.rows, 16), device="cuda",
                            dtype=torch.int32,
                            generator=torch.Generator("cuda").manual_seed(12))
        pts.view(group.rows // nw, nw, 16)[:, -2:] = 0
        if one:
            fn = lambda: K.tree_sum(pts[:, :2].contiguous(), group)  # noqa: E731
        else:
            a, b = pts[:, :1].contiguous(), pts[:, 1:2].contiguous()
            fn = lambda: K.fused_add(a, b, group)  # noqa: E731
        res[f"add_latency{key}"] = kernel_ms(fn, 5)
        res[f"add_latency{key}_device_us"] = device_us(fn, 5)
        if not one:
            return
        m, g = pts[:, :1].contiguous(), pts[:, 1:2].contiguous()
        for steps in (1, 2, 8, 16):
            walk = pts[:, :steps].contiguous()
            res[f"running_lane{key}_{steps}_device_us"] = device_us(
                lambda: K.running_sum(m, g, walk, steps, group), 5)

    def warm(key, fn, args, reps):
        fn(*args)
        times = []
        for _ in range(reps):
            _, dt = cs.fenced(fn, *args)
            times.append(dt)
        res[key] = statistics.median(times), times

    for curve, tag in (("bls12_377", ""), ("edwards_bls12", "_ed")):
        cid = CurveId(curve)
        for power, chunk, forced in ((16, 15, False), (14, 4, True)):
            t0 = time.perf_counter()
            pw, sw, _ = cs.bench_case(power, curve)
            torch.cuda.synchronize()
            key = f"{tag}_{power}"
            res[f"bench_case{key}_s"] = time.perf_counter() - t0
            # row 11: the legacy SMVP with its BPR, on the operands of one
            # call (the parent's rounds, gathers, readback and groups; or
            # the one launch over the pieces and the fold)
            eng = (CuzkMsmEngine(cid, chunk_size=chunk, smvp_mode="legacy")
                   if forced else PippengerMsmEngine(cid))
            # (the parent's _smvp_legacy, or the plan, the sum and BPR;
            # both take (engine, table, plan, chunk, windows))
            name = ("_smvp_legacy" if hasattr(CuzkMsmEngine, "_smvp_legacy")
                    else "_plan_legacy")
            calls = captured(eng.compute_msm, (pw, sw), (CuzkMsmEngine, name))
            args = calls[name][0]
            smvp = (CuzkMsmEngine._smvp_legacy if name == "_smvp_legacy"
                    else legacy_smvp)
            slow = forced and not fresh  # ~20,000 launches a call
            timed(f"row11{key}_smvp", lambda: smvp(*args),
                  reps=2 if slow else 5, calls=1 if slow else 5)
            if fresh:
                _, table, plan, _, _ = args
                group = eng.group
                pp = SK.piece_plan(plan.starts, plan.lens,
                                   plan.sorted_vals.shape[0],
                                   table.shape[0] // 2)
                res[f"row11{key}_shape"] = dict(
                    buckets=plan.lens.numel(), pieces=int(pp.counts.sum()),
                    entries=int(plan.lens.sum()),
                    longest=int(plan.lens.max()))
                timed(f"row11{key}_pieces", lambda: buckets.legacy_buckets(
                    table, plan.sorted_vals, pp.starts, pp.lens, group))
                timed(f"row11{key}_unsplit", lambda: buckets.legacy_buckets(
                    table, plan.sorted_vals, plan.starts, plan.lens, group),
                    reps=3, calls=1)
                sums = buckets.legacy_buckets(table, plan.sorted_vals,
                                              pp.starts, pp.lens, group)
                res[f"fold{key}"] = kernel_ms(lambda: SK.fold_pieces(
                    sums, pp.counts, pp.offsets, pp.caps, group), 5)
            warm(f"msm{key}_legacy", eng.compute_msm, (pw, sw),
                 2 if slow else 5)
            if power != 16:
                continue
            # rows 12a and 12b: the naive engine's scalar multiplication
            # and tree sum on one call's operands
            fn = NaiveMsmEngine(cid).build_fn()
            calls = captured(fn, (pw, sw), (naive, "batched_scalar_mult"),
                             (naive, "tree_sum"))
            sm_args = calls["batched_scalar_mult"][0]
            ts_args = calls["tree_sum"][0]
            timed(f"row12a{key}", lambda: naive.batched_scalar_mult(*sm_args))
            timed(f"row12b{key}", lambda: naive.tree_sum(*ts_args))
            warm(f"msm{key}_naive", fn, (pw, sw), 5)
            # row 12c: the running-sum chain on its operands (the parent's
            # steps, each a launch, or the one launch over the walk)
            one = hasattr(K, "running_sum")
            name = "running_sum" if one else "fused_running_add"
            steps = captured(cs.running_sum_chain, (pw, curve),
                             (K, name))[name]

            def chain():
                for a in steps:
                    getattr(K, name)(*a)
            timed(f"row12c{key}", chain)
            add_latency(key, ts_args[1], one)
            del args, calls, sm_args, ts_args, steps
    print(smi)
    print(json.dumps(res))
    return 0


def bpr_rows(opts, smi, kernel_ms) -> int:
    """--bpr: rows 1 and 5-8 (see the module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from webgpu_msm_bls12_377_tpu_torch import compute_msm, compute_msm_edwards
    from webgpu_msm_bls12_377_tpu_torch.models import cuzk
    from webgpu_msm_bls12_377_tpu_torch.ops import bpr
    from webgpu_msm_bls12_377_tpu_torch.ops import convert
    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    res = {"label": opts.label, "card": smi}
    variants = {}
    if opts.variants:
        t0 = time.perf_counter()
        dirs = K.build_variants(("bpr",), BPR_VARIANTS)
        res["variant_build_s"] = time.perf_counter() - t0
        variants = {v: K.load_variant(d, ("bpr",)) for v, d in dirs.items()}
        for v, d in dirs.items():
            for f in sorted(d.glob("*.log")):
                res[f"regs_{v}_{f.stem}"] = ptxas_regs(f.read_text())
    K._lib("bpr")  # the checkout's own build
    for f in sorted(K._build_dir().glob("bpr*.log")):
        res[f"regs_default_{f.stem}"] = ptxas_regs(f.read_text())

    def each_variant(key, fn):
        res[key] = kernel_ms(fn, 5)
        res[f"{key}_device_us"] = device_us(fn)
        for v, libs in variants.items():
            with K.using(libs):
                res[f"{key}_{v}"] = kernel_ms(fn, 5)

    for curve, group, tag in (("bls12_377", C.G1, ""),
                              ("edwards_bls12", C.EDWARDS, "_ed")):
        run = compute_msm if group is C.G1 else compute_msm_edwards
        for power, chunk in ((20, 16), (17, 15), (14, 4)):
            pw, sw, _ = cs.bench_case(power, curve)
            names = [(cuzk, "reduce_buckets_prearranged")]
            if power == 20:
                names += [(cuzk, "mont_mul_const")]
                names += ([(cuzk, "point_prep")] if hasattr(cuzk, "point_prep")
                          else [(convert, "mont_mul_const")])
            calls = captured(run, (pw, sw), *names)
            key = f"{tag}_{power}"
            if power == 20:
                # row 1: kernel 1's launches of the call, each on its
                # operands: the entry (the point prep) and the exit
                launches = [("prep", K.point_prep, args)
                            for args in calls.get("point_prep", [])]
                launches += [("mmc", K.mont_mul_const, args)
                             for args in calls.get("mont_mul_const", [])]
                for i, (kind, fn, args) in enumerate(launches):
                    res[f"row1{key}_launch{i}"] = kernel_ms(
                        lambda: fn(*args), 5)
                    res[f"row1{key}_launch{i}_device_us"] = device_us(
                        lambda: fn(*args))
                    res[f"row1{key}_launch{i}_shape"] = [kind, list(
                        args[0].shape)]
            # the tree, stream and fused paths reduce once a call
            buckets, windows, chunk_, threads, _ = calls[
                "reduce_buckets_prearranged"][0]
            h = 1 << (chunk_ - 1)
            t_count = min(threads, h)
            bpt = h // t_count
            lanes = windows * t_count
            res[f"bpr{key}_shape"] = dict(windows=windows, T=t_count, bpt=bpt)
            if bpt > 1:
                split = bpr.stage1_split(lanes, bpt, group)
                res[f"bpr{key}_split"] = split
                each_variant(f"row5{key}", lambda: K.bpr_stage1(
                    buckets, bpt, split, group))
                m, g = K.bpr_stage1(buckets, bpt, split, group)
            else:
                m = g = buckets
            if hasattr(K, "bpr_stage2"):
                def stage2():
                    return K.bpr_stage2(m, g, t_count, bpt, group)
                g2 = stage2()

                def fold():
                    return K.bpr_fold(g2, windows, t_count, group)
            else:
                bits, partners, lane0 = bpr._stage2_consts(windows, t_count,
                                                           dev)

                def stage2():
                    temp, acc = m, g
                    for _ in range(bpt.bit_length() - 1):
                        temp = K.bpr_double(temp, group)
                    for row in bits:
                        acc, temp = K.bpr_masked_add_double(acc, temp, row,
                                                            group)
                    return acc
                g2 = stage2()

                def fold():
                    acc = g2
                    for partner in partners:
                        acc = K.bpr_add(acc, acc[:, partner].contiguous(),
                                        group)
                    return acc[:, lane0]
            each_variant(f"row67{key}", stage2)
            each_variant(f"row8{key}", fold)
            res[f"bpr{key}"] = kernel_ms(lambda: bpr.reduce_buckets_prearranged(
                buckets, windows, chunk_, threads, group), 5)
            del buckets, m, g, g2, calls
    print(smi)
    print(json.dumps(res))
    return 0



def prep_rows(opts, smi, kernel_ms) -> int:
    """--prep: row 1's point prep and the copy (see the module docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from webgpu_msm_bls12_377_tpu_torch import compute_msm, compute_msm_edwards
    from webgpu_msm_bls12_377_tpu_torch.models import cuzk
    from webgpu_msm_bls12_377_tpu_torch.ops import convert
    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S

    dev = torch.device("cuda")
    res = {"label": opts.label, "card": smi}
    new = hasattr(K, "point_prep")
    variants = {}
    if opts.variants and new:
        dirs = K.build_variants(("convert",), PREP_VARIANTS)
        variants = {v: K.load_variant(d, ("convert",))
                    for v, d in dirs.items()}
        for v, d in dirs.items():
            res[f"regs_{v}"] = {f.stem: prep_regs(f.read_text())
                                for f in sorted(d.glob("*.log"))}
    K._lib("convert")  # the checkout's own build
    res["regs_default"] = {f.stem: prep_regs(f.read_text()) for f in
                           sorted(K._build_dir().glob("convert*.log"))}
    workers = ([int(w) for w in opts.workers.split(",")]
               if hasattr(cuzk, "STAGE_WORKERS") else [None])

    def host_ms(fn, reps=5):
        """fn() fenced, host clock, after one untimed call: (median, all)."""
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out), out

    def split(words, reps=5):
        """The unchunked staging in its three parts, ms: (pinned buffer,
        host fill, device copy) medians and all runs."""
        host = words.view(np.int32)
        parts = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            staged = torch.empty(host.shape, dtype=torch.int32,
                                 pin_memory=True)
            t1 = time.perf_counter()
            np.copyto(staged.numpy(), host)
            t2 = time.perf_counter()
            staged.to(dev, non_blocking=True)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            parts.append([(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3])
        parts = parts[1:]
        return {name: (statistics.median(p[i] for p in parts),
                       [p[i] for p in parts])
                for i, name in enumerate(("pinned", "fill", "device"))}

    def copy_times(key, words):
        for w in workers:
            with contextlib.ExitStack() as stack:
                if w is not None:
                    stack.enter_context(staged_by(cuzk, w))
                res[f"{key}_copy" + ("" if w is None else f"_w{w}")] = host_ms(
                    lambda: cuzk.words_to_device(words, dev))
        res[f"{key}_split"] = split(words)

    for curve, group, tag in (("bls12_377", C.G1, ""),
                              ("edwards_bls12", C.EDWARDS, "_ed")):
        run = compute_msm if group is C.G1 else compute_msm_edwards
        k = group.ctx.nw - 1
        for power in (20, 17):
            pw, sw, _ = cs.bench_case(power, curve)
            pbuf, sbuf = cs.to_wire(pw, sw)
            n = 1 << power
            wire = np.frombuffer(pbuf, dtype="<u4").reshape(n, 2 * k)
            wire_sw = np.frombuffer(sbuf, dtype="<u4").reshape(n, 8)
            key = f"{tag}_{power}"
            copy_times(f"words{key}", pw)
            copy_times(f"bytes{key}", wire)
            copy_times(f"scalars{key}", sw)
            copy_times(f"bytes_scalars{key}", wire_sw)
            if not new:
                res[f"unpack{key}"] = host_ms(lambda: (
                    convert.points_buffer_to_words(pbuf, 4 * k),
                    convert.scalars_buffer_to_words(sbuf)))
            if new:
                from webgpu_msm_bls12_377_tpu_torch.ops.convert import (
                    WireLayout,
                )

                forms = {"signed": K.SIGNED, "plane": K.PLANE}
                for major, arr in (("words", pw), ("bytes", wire)):
                    lay = WireLayout.of(arr, major == "bytes", k, 2)
                    dw = cuzk.words_to_device(arr, dev)
                    for fname, form in forms.items():
                        name = f"prep_{major}_{fname}{key}"

                        def prep():
                            return K.point_prep(dw, lay, group, form)
                        res[name] = kernel_ms(prep, 5)
                        res[f"{name}_device_us"] = device_us(prep)
                        for v, libs in variants.items():
                            with K.using(libs):
                                res[f"{name}_{v}"] = kernel_ms(prep, 5)
            else:
                dw = cuzk.words_to_device(pw, dev)

                def prep():
                    return S.build_signed_table(
                        cuzk.mont_point_table(dw, group), group)
                res[f"prep_words_signed{key}"] = kernel_ms(prep, 5)
                res[f"prep_words_signed{key}_device_us"] = device_us(prep)
                res[f"prep_words_plane{key}"] = kernel_ms(
                    lambda: cuzk.mont_point_table(dw, group), 5)
            if power == 20:
                res[f"msm_words{key}"] = host_ms(lambda: run(pw, sw))
                res[f"msm_bytes{key}"] = host_ms(lambda: run(pbuf, sbuf))
            del pw, sw, pbuf, sbuf, wire, wire_sw
    print(smi)
    print(json.dumps(res))
    return 0


@contextlib.contextmanager
def staged_by(cuzk, workers: int):
    """The checkout's staged copy with `workers` host threads."""
    saved = cuzk.STAGE_WORKERS
    cuzk.STAGE_WORKERS = workers
    try:
        yield
    finally:
        cuzk.STAGE_WORKERS = saved


def prep_regs(log: str) -> dict:
    """{kernel: "<registers> regs, <spill stores> B spilled"} of one
    convert library's ptxas log (the point prep's four forms, the exit)."""
    out, kernel, spill = {}, None, "0"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if kernel and m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if kernel and m:
            out[kernel] = f"{m.group(1)} regs, {spill} B spilled"
            kernel = None
    return out


if __name__ == "__main__":
    sys.exit(main())
