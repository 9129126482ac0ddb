#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which fails the run on any error:
  1. the card's name and power limit (nvidia-smi), and the build of every
     kernel library with nvcc: each source under
     webgpu_msm_bls12_377_tpu_torch/csrc/ for BLS12-377 and again with
     -DMSM_CURVE_ED for Twisted Edwards BLS12 (16 libraries, 36 entry
     points);
  2. every kernel entry point, both curves, against its plain PyTorch form
     on random inputs of a few thousand lanes (the point prep from wire
     words in both layouts to both its forms, 0, 1, p - 1 and p among the
     coordinates; identity, equal and inverse
     operands among the canonical family's, the tree sum at one and two
     blocks and at 2^18, each launch twice; BPR stage 2 and the fold at
     T = 1, 8 and 1,024 lanes a window, 1 and 17 windows, bpt 1, 2 and
     64; the scalar multiplication at bits 0, 1, 7 and 256),
     and on a small real plan for
     the tree, finish, stream and fused kernels (the fused path's two
     passes: kernel 8 over pieces of at most PIECE rows, and the fold in
     one launch of tree.cu's msm_fold_pieces); tree.cu's carry-chain
     Montgomery products on their own (field_mul_lanes) at extreme
     operands (R - 1, carries at every word, the formulas' largest
     bounds); the fold on buckets of up to 2,048 pieces: bit-exact
     equality;
  3. every path through the entry points a user calls, on the
     distinct-point bench cases held against the pinned goldens in
     test-data/goldens.json: compute_msm with default options at 2^10 and
     2^14 (fused path, chunk 4), 2^16 and 2^17 (stream path, chunk 15),
     2^18 and 2^20 (hybrid tree, chunk 15 and 16), and at 2^20 again from
     the reference's wire bytes; beside the 2^14 default,
     the same case forced through the legacy path (chunk 4) and the stream
     path (chunks 9 and 13); the fused path forced at 2^16 and chunk 15;
     the pure tree forced at 2^18;
     PippengerMsmEngine (legacy path) and NaiveMsmEngine at 2^16; a
     running-sum chain through the one kernel no engine calls (one launch
     over the walk), held against the bigint oracle; compute_msm_batch of
     8 scalar sets at 2^20 (tree) against the pinned batch goldens and of
     4 sets at 2^17 (stream) against compute_msm per set, each with
     PyTorch's sync debug mode raising on any wait for the device between
     sets.  Edwards:
     compute_msm_edwards with default options at the same six sizes and
     from wire bytes at 2^20, the
     2^14 case forced through legacy, Pippenger, naive and the chain at
     2^16, the pure tree forced at 2^18 and a batch of 8 sets at 2^20,
     against the edwards_bls12 goldens from 2^16 and below that against
     msm_oracle ((sum of s_i k_i mod r) * G for the bench points k_i * G),
     which first reproduces the 2^16 golden.  Cold time,
     median of 3 warm runs, and each kernel's launches in one run (counts
     zeroed just before, read just after); every path must launch the
     kernels it names (the point prep, the legacy SMVP, the scalar
     multiplication, the tree sum and the running sum once a run), and
     together the paths cover every kernel.  The bench inputs come from
     the port's harness/testdata.py (points made on the card).  Then the
     harness: make_zipf_case (scalars zipf(1.2) from a pool of 2^8) at
     2^20 (hybrid tree) and 2^17 (stream), both curves, against the
     known-k oracle, each warm median beside the uniform case's;
     debug_check at 2^17, both curves, every stage True; and
     bench_torch.py --n 65536 --runs 2 --prewarm in a subprocess, its last
     line a checked JSON result.  Then the harness's second part
     (harness2_runs): autotune (window sizes 13, 15 and 16, then the
     stream path against the hybrid tree at K = 1, 2 and 3) at 2^20, both
     curves, and at 2^16 G1, on a tuning table in a temporary directory
     (every other phase reads an empty one, never the repo's), every
     candidate's time and the winner against the static policy logged,
     and an engine with the default autotune=True over that table
     resolving the winners and giving the golden; the sweep
     (run_power at 2^16 and 2^20, one warm run each, verified, its
     Markdown table); the microbench at 2^19 lanes and its product study
     (tree.cu's msm_word_rate in the carry-chain and the -DMSM_MONT_C
     build, both fields, each first held against its plain form), both
     curves;
  4. one more run of each path (2^20 tree, 2^17 stream, 2^16 legacy, 2^16
     naive, the chain, 2^10 and 2^14 default fused, the forced fused run
     at 2^16 and chunk 15, 2^18 pure tree; Edwards 2^20 tree, 2^17
     stream, 2^16 legacy, naive and chain, 2^10 and 2^14 fused) in which
     every kernel launch is timed with
     CUDA events and repeated with its plain form on the same inputs,
     which must agree bit for bit: per-kernel time, plain time and the
     bound (least time for the same work on an H100 SXM); the stream
     kernel five more times; every row's bound again at the card's 32-bit
     word-product rate in the carry-chain Montgomery product on its own
     (phase 3's product study, both fields: int_bound_ms).  The plain
     forms of the lane-wise kernels (1, the tree sum and the running sum)
     are replayed from CUDA graphs, one captured per shape, and kernel 8's
     round from one graph a launch (fused_plain_graphed); phase 2 holds
     the replays against the plain forms run eagerly;
  5. one more 2^20, 2^20 from wire bytes, 2^17, 2^16, 2^14, Edwards 2^20
     (also from wire bytes) and Edwards 2^14 MSM
     with every engine stage fenced and timed, and one more 2^20 batch
     fenced as shared prep, per-set stages, and readback with Horner; the
     engine's host-to-device copy of the 2^20 words (word arrays and the
     wire bytes' point-major words) beside one plain .to(device) and beside
     one unchunked staging split into its pinned buffer, host fill and
     device copy; with --profile, also torch.profiler over one 2^20 (both
     curves), 2^17, 2^14 (both curves), Pippenger and naive (both curves)
     run and one batch: the device's busy and idle share and the ops that
     take the most device time.
Then three lines: the per-kernel JSON record, the card's name and power
limit as nvidia-smi prints them, and last {"ok": true, "device": {...}}.
Each phase logs its start and the last log line its seconds.
Exits nonzero, printing no result, when no CUDA device is present or the
package is missing.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

try:
    # the bench inputs: the port's harness/testdata.py
    from webgpu_msm_bls12_377_tpu_torch.harness.testdata import (  # noqa: F401
        MTWords,
        batch_inverse,
        batch_scalars,
        bench_words,
        make_zipf_case,
        msm_oracle,
        randrange_words,
        to_wire,
        words_to_ints,
    )
except ImportError:  # no torch, or no package: main() says which
    pass

#: H100 SXM published peaks: HBM bytes/s, and 32-bit
#: multiply-adds/s taken as half the 67 TFLOP/s float32 rate (the card
#: publishes no integer rate; one 32x32->64 word product = one multiply-add)
PEAK_BYTES = 3.35e12
PEAK_MULS = 67e12 / 2
MM, MMP = 2 * 13 * 13, 3 * 13 * 13  # word products: Montgomery product, pair
MM_ED = 2 * 9 * 9  # an Edwards (9-word) Montgomery product
#: word products and bytes by kernel-name suffix: G1 "" (RCB; lazy forms
#: with paired products: affine add 4 products and 3 pairs, full add 6 and
#: 3, mixed add 5 and 3; canonical add 12 products, mixed add 11, double
#: 8), Edwards "_ed" (hwcd: lazy and canonical mixed and affine add 9
#: products, full add 10, double 8; 4 coordinates a point, 3 an addend).
#: cw: the words a coordinate must move: values stay below 20p < 2^382
#: (G1) and 8p < 2^256 (Edwards), so 12 of G1's 13 words and 8 of
#: Edwards' 9 (the top word is always zero); pt and aff bytes count cw
#: words a coordinate
WORK = {
    "": dict(mm=MM, add_aff=4 * MM + 3 * MMP, add_full=6 * MM + 3 * MMP,
             add_mixed=5 * MM + 3 * MMP, dbl=8 * MM, add_canon=12 * MM,
             add_mixed_canon=11 * MM, dbl_canon=8 * MM, pt=3 * 48, aff=2 * 48,
             cw=12),
    "_ed": dict(mm=MM_ED, add_aff=9 * MM_ED, add_full=10 * MM_ED,
                add_mixed=9 * MM_ED, dbl=8 * MM_ED, add_canon=10 * MM_ED,
                add_mixed_canon=9 * MM_ED, dbl_canon=8 * MM_ED, pt=4 * 32,
                aff=3 * 32, cw=8),
}
BENCH = ((10, 4), (14, 4), (16, 15), (17, 15), (18, 15), (20, 16))  # (power, chunk)
#: bytes the fused kernel loads of one pre-gathered row: seven 16-byte
#: loads (the first 28 of its 32 words), either curve
ROW = 7 * 16
BATCH_SETS, STREAM_BATCH_SETS = 8, 4
FORCED_CHUNK = 15  # the forced fused run: the Pippenger row's shapes at 2^16
FORCED_14 = (9, 13)  # stream chunks forced at 2^14, beside the default's 4
DEV = "cuda"
ED = "edwards_bls12"
START = time.perf_counter()

KERNELS = {
    # name: (source, TPU kernel it replaces)
    # kernel 1's entry: wire words to the signed or the Montgomery table in
    # one launch
    "point_prep": ("webgpu_msm_bls12_377_tpu_torch/csrc/convert.cu",
                   "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:238"),
    # kernel 1's exit (y = 1) on the window sums
    "mont_mul_const": ("webgpu_msm_bls12_377_tpu_torch/csrc/convert.cu",
                       "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:238"),
    "tree_level_aff": ("webgpu_msm_bls12_377_tpu_torch/csrc/tree.cu",
                       "webgpu_msm_bls12_377_tpu/ops/smvp_tree.py:416"),
    "tree_level_full": ("webgpu_msm_bls12_377_tpu_torch/csrc/tree.cu",
                        "webgpu_msm_bls12_377_tpu/ops/smvp_tree.py:416"),
    "packed_finish": ("webgpu_msm_bls12_377_tpu_torch/csrc/packed.cu",
                      "webgpu_msm_bls12_377_tpu/ops/smvp_stream.py:475"),
    "bpr_stage1": ("webgpu_msm_bls12_377_tpu_torch/csrc/bpr.cu",
                   "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:451"),
    # stage 2 in one launch: the TPU's lazy doublings (:383) and masked
    # double-and-add steps (:468)
    "bpr_stage2": ("webgpu_msm_bls12_377_tpu_torch/csrc/bpr.cu",
                   "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:468 and :383"),
    # the window fold in one launch: every level's lazy add
    "bpr_fold": ("webgpu_msm_bls12_377_tpu_torch/csrc/bpr.cu",
                 "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:435"),
    "stream_buckets": ("webgpu_msm_bls12_377_tpu_torch/csrc/stream.cu",
                       "webgpu_msm_bls12_377_tpu/ops/smvp_stream.py:541"),
    # every legacy round in one launch: the TPU's masked mixed add
    "legacy_buckets": ("webgpu_msm_bls12_377_tpu_torch/csrc/legacy.cu",
                       "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:272"),
    # the naive engine's whole tree sum in one launch: the TPU's add, a
    # launch a level
    "tree_sum": ("webgpu_msm_bls12_377_tpu_torch/csrc/canon.cu",
                 "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:302"),
    # the whole double-and-add in one launch: the TPU's one step
    "scalar_mult": ("webgpu_msm_bls12_377_tpu_torch/csrc/canon.cu",
                    "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:488"),
    # the whole running-sum chain in one launch: the TPU's one step
    "running_sum": ("webgpu_msm_bls12_377_tpu_torch/csrc/canon.cu",
                    "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:415"),
    "fused_buckets": ("webgpu_msm_bls12_377_tpu_torch/csrc/fused.cu",
                      "webgpu_msm_bls12_377_tpu/ops/smvp_kernel.py:223"),
    # the fused path's fold: row 3's full-level pairing, every bucket in
    # one launch
    "fold_pieces": ("webgpu_msm_bls12_377_tpu_torch/csrc/tree.cu",
                    "webgpu_msm_bls12_377_tpu/ops/smvp_tree.py:416"),
}
BPR = ("bpr_stage1", "bpr_stage2", "bpr_fold")
# the Edwards build (-DMSM_CURVE_ED) of every source; its point prep also
# computes t = x*y (an XLA product in the JAX package, outside any Pallas
# kernel)
KERNELS.update({f"{k}_ed": KERNELS[k] for k in list(KERNELS)})
KERNELS["point_prep_ed"] = (
    "webgpu_msm_bls12_377_tpu_torch/csrc/convert.cu",
    "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:238 with "
    "webgpu_msm_bls12_377_tpu/models/cuzk.py:166")
BPR_ED = tuple(k + "_ed" for k in BPR)
#: kernel 1's two entry points, as every path of a curve launches them
PREP, PREP_ED = ("point_prep", "mont_mul_const"), ("point_prep_ed",
                                                   "mont_mul_const_ed")
#: the kernels each path must launch; a kernel's row in the JSON record
#: (launches, times, bound) comes from the first path that names it
PATHS = {
    "tree": (*PREP, "tree_level_aff", "tree_level_full",
             "packed_finish", *BPR),
    "stream": ("stream_buckets", *PREP, *BPR),
    # default options at 2^10 and 2^14: chunk 4 has 8 buckets a window,
    # one per BPR lane, so BPR runs no stage 1 (stage 2 no doublings); the
    # fused kernel's row is the 2^10 run's (phase 4 times the 2^14 run
    # too); the fused paths fold each bucket's pieces in one launch of
    # tree.cu's fold (its row is the 2^10 run's)
    "fused_10": ("fused_buckets", "fold_pieces", *PREP,
                 "bpr_stage2", "bpr_fold"),
    "fused": ("fused_buckets", "fold_pieces", *PREP,
              "bpr_stage2", "bpr_fold"),
    # the legacy path sums every bucket in one launch (at 2^16, chunk 15:
    # ~4 entries a bucket)
    "legacy": ("legacy_buckets", *PREP, *BPR),
    "naive": ("scalar_mult", "tree_sum", *PREP),
    # no engine of either package calls the running add: the chain drives
    # it in one launch over the walk, beside BPR stage 1 on the same walk,
    # whose g must be the same points
    "running_sum": ("running_sum", "bpr_stage1", "point_prep"),
    # the 2^14 case forced off its default path, for the times alone; at
    # chunk 4 the legacy path sums pieces and folds them
    "legacy_14": ("legacy_buckets", "fold_pieces", *PREP, "bpr_stage2",
                  "bpr_fold"),
    "stream_14": ("stream_buckets", *PREP),
    "fused_forced": ("fused_buckets", "fold_pieces", *PREP, *BPR),
    "pure_tree": ("tree_level_aff", "tree_level_full", *PREP, *BPR),
    "ed_tree": (*PREP_ED, "tree_level_aff_ed", "tree_level_full_ed",
                "packed_finish_ed", *BPR_ED),
    "ed_stream": ("stream_buckets_ed", *PREP_ED, *BPR_ED),
    "ed_pure_tree": ("tree_level_aff_ed", "tree_level_full_ed", *PREP_ED,
                     *BPR_ED),
    # Edwards on the G1 shapes above: the default fused path at 2^10 and
    # 2^14 (the kernel's and the fold's rows from 2^10), Pippenger and
    # naive at 2^16, the chain, and the 2^14 case forced through legacy
    "ed_fused_10": ("fused_buckets_ed", "fold_pieces_ed", *PREP_ED,
                    "bpr_stage2_ed", "bpr_fold_ed"),
    "ed_legacy": ("legacy_buckets_ed", *PREP_ED, *BPR_ED),
    "ed_naive": ("scalar_mult_ed", "tree_sum_ed", *PREP_ED),
    "ed_running_sum": ("running_sum_ed", "bpr_stage1_ed", "point_prep_ed"),
}
PATHS["batch_tree"], PATHS["batch_stream"] = PATHS["tree"], PATHS["stream"]
PATHS["ed_batch_tree"] = PATHS["ed_tree"]
# the 2^20 cases again from the reference's wire bytes
PATHS["wire_tree"], PATHS["ed_wire_tree"] = PATHS["tree"], PATHS["ed_tree"]
PATHS["ed_fused"] = PATHS["ed_fused_10"]
PATHS["ed_legacy_14"] = ("legacy_buckets_ed", "fold_pieces_ed", *PREP_ED,
                         "bpr_stage2_ed", "bpr_fold_ed")
#: the kernels a run launches once: the point prep (a batch's included),
#: the whole legacy SMVP, the whole scalar multiplication, the whole tree
#: sum and the whole running-sum chain
ONCE = ("point_prep", "legacy_buckets", "scalar_mult", "tree_sum",
        "running_sum")
HOME = {k: path for path in reversed(PATHS) for k in PATHS[path]}
#: phase 2's entry points that no path launches: tree.cu's Montgomery
#: products on their own (the carry-chain schedule at extreme operands),
#: and bpr.cu's lane-wise lazy add (the join of sharded partial window
#: sums)
LANE_CHECKS = ("field_mul_lanes", "field_mul_lanes_ed", "bpr_add",
               "bpr_add_ed")
#: phase 2's shapes of BPR stage 2 and the fold: lanes a window (T),
#: windows, buckets a lane (bpt)
BPR_T, BPR_WINDOWS, BPR_BPT = (1, 8, 1024), (1, 17), (1, 2, 64)


def log(*a):
    print(*a, flush=True)


#: (phase, seconds since the start) at each phase's start
PHASE_STARTS: list[tuple[str, float]] = []


def phase(name: str, what: str) -> None:
    """Log a phase's start; phase_seconds adds up each phase's time."""
    PHASE_STARTS.append((name, elapsed()))
    log(f"{name} at {elapsed():.1f} s: {what}")


def phase_seconds() -> dict[str, float]:
    """Seconds spent in each phase so far (a phase entered again adds)."""
    ends = [t for _, t in PHASE_STARTS[1:]] + [elapsed()]
    secs: dict[str, float] = {}
    for (name, t), end in zip(PHASE_STARTS, ends):
        secs[name] = round(secs.get(name, 0.0) + end - t, 1)
    return secs


def elapsed() -> float:
    """Seconds since the script started."""
    return time.perf_counter() - START


def max_abs_err(a, b) -> int:
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def rand_plane(rng, rows, n, bound, nw=13):
    """(rows, n) plane of random values < bound (a multiple of p)."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import field as F

    planes = [F.ints_to_plane([rng.randrange(bound) for _ in range(n)], nw=nw)
              for _ in range(rows // nw)]
    return torch.cat(planes).to(DEV)


def extreme_values(ctx):
    """Operands that put a carry at every word of a Montgomery product:
    R - 1, runs of all-ones words, all-ones words but one, alternating
    words, 0, 1, p - 1, p, R - p, and k p - 1 for every bound k the point
    formulas give a product's operand (ops/curve.py)."""
    nw, p = ctx.nw, ctx.p
    r = 1 << (32 * nw)
    ones = (1 << 32) - 1
    vals = [r - 1, 0, 1, p - 1, p, r - p]
    vals += [(1 << (32 * k)) - 1 for k in range(1, nw)]
    vals += [(r - 1) ^ (ones << (32 * k)) for k in range(nw)]
    vals += [sum(ones << (32 * k) for k in range(s, nw, 2)) for s in (0, 1)]
    vals += [k * p - 1 for k in (2, 4, 6, 8, 12, 14, 16, 18, 20)]
    return vals


def field_cases(rng, ctx, n=4096):
    """Phase 2: tree.cu's mont_mul and mont_mul_pair (the carry-chain
    schedule, K.field_mul_lanes) against ops/field.py on every pair of
    extreme operands (the pair's second product on the reversed pairs) and
    on n random operands below R."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import field as F
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K

    ext = extreme_values(ctx)
    a = [x for x in ext for _ in ext]
    b = [y for _ in ext for y in ext]
    r = 1 << (32 * ctx.nw)
    rand = [[rng.randrange(r) for _ in range(n)] for _ in range(4)]
    ops = [torch.cat([F.ints_to_plane(v, nw=ctx.nw) for v in (x, y)], dim=1)
           .to(DEV) for x, y in zip((a, b, b[::-1], a[::-1]), rand)]
    got = K.field_mul_lanes(*ops, ctx)
    want = K.field_mul_lanes_plain(*ops, ctx)
    return [("field_mul_lanes" + ctx.tag, g, w) for g, w in zip(got, want)]


def wire_point_words(rng, ctx, n):
    """(n, 2k) point-major wire words of random coordinates below 2^(32 k)
    (a wire coordinate takes any value of its k words), with 0, 1, p - 1
    and p among them."""
    import numpy as np

    k, p = ctx.nw - 1, ctx.p
    vals = [[rng.randrange(1 << (32 * k)) for _ in range(n)] for _ in range(2)]
    for i, v in enumerate((0, 1, p - 1, p, 0, p - 1, 1, p)):
        vals[i % 2][(7 * i) % n] = v
    buf = b"".join(vals[0][j].to_bytes(4 * k, "little")
                   + vals[1][j].to_bytes(4 * k, "little") for j in range(n))
    return np.frombuffer(buf, dtype="<u4").reshape(n, 2 * k)


def prep_cases(rng, group, n=4096):
    """Phase 2: kernel 1's point prep from wire words in both layouts
    (point-major as a wire buffer holds them, word-major as the packers
    give them) to both its forms, against point_prep_plain."""
    import numpy as np
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops.convert import WireLayout

    ctx = group.ctx
    k = ctx.nw - 1
    pm = wire_point_words(rng, ctx, n)
    cases = []
    for words, point_major in (
            (pm, True),
            (np.ascontiguousarray(pm.reshape(n, 2, k).transpose(1, 2, 0)),
             False)):
        layout = WireLayout.of(words, point_major, k, 2)
        t = torch.from_numpy(words.view(np.int32).copy()).to(DEV)
        for out in (K.SIGNED, K.PLANE):
            cases.append(("point_prep" + ctx.tag,
                          K.point_prep(t, layout, group, out),
                          K.point_prep_plain(t, layout, group, out)))
    return cases


def lazy_kernel_cases(rng, group, n=4096):
    """Phase 2 for the kernels both curves build: kernel 1 (the point prep
    in both layouts and forms; the constant product, entry and exit
    constants), the BPR family on lazy
    operands (stage 1 at bpt 1, 2 and 8, split 1 to 4; stage 2 and the
    fold at every T, window count and bpt of BPR_*; the lane-wise add), and
    on a small
    real plan (2048 points, chunk 8, K = 2) tree levels 1 and 2 (level 2
    also as node rows), the packed finish on those rows and the stream
    kernel.  Returns (cases, Montgomery table, signed table,
    plan, windows)."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_tree as T
    from webgpu_msm_bls12_377_tpu_torch.ops.buckets import build_bucket_plan
    from webgpu_msm_bls12_377_tpu_torch.ops.decompose import (
        decompose_scalars_signed,
    )

    ctx, tag = group.ctx, group.ctx.tag
    nw, p, bound = ctx.nw, ctx.p, 2 * ctx.p  # lazy values below 2p
    cases = field_cases(rng, ctx) + prep_cases(rng, group, n)
    a = rand_plane(rng, 2 * nw, n, p, nw)
    for y in (ctx.params.r2, 1):
        cases.append(("mont_mul_const" + tag, K.mont_mul_const(a, y, ctx),
                      K.mont_mul_const_plain(a, y, ctx)))
    m, g, b = (rand_plane(rng, group.rows, n, bound, nw) for _ in range(3))
    # stage 1 over 2,048 lanes, the steps drawn from m, g and b: no steps
    # (bpt 1), sub-walks of one step (bpt 2, split 2), the unsplit walk and
    # a split one with its doublings (bpt 8, split 1 and 4)
    pool = torch.cat([m, g, b], dim=1)
    pairs = []
    for bpt, split in ((1, 1), (2, 2), (8, 1), (8, 4)):
        pick = torch.randint(0, 3 * n, (bpt * 2048,),
                             generator=torch.Generator().manual_seed(bpt))
        steps = pool[:, pick.to(DEV)].contiguous()
        pairs.append(("bpr_stage1", K.bpr_stage1(steps, bpt, split, group),
                      K.bpr_stage1_plain(steps, bpt, split, group)))
    pairs.append(("bpr_add", K.bpr_add(m, b, group), K.add_plain(m, b, group)))
    # stage 2 and the fold at every T, window count and bpt of BPR_*, on
    # lanes drawn from m, g and b
    for t_count in BPR_T:
        for windows_ in BPR_WINDOWS:
            lanes = t_count * windows_
            for bpt in BPR_BPT:
                sm, sg = (pool[:, torch.randint(
                    0, 3 * n, (lanes,), generator=torch.Generator().manual_seed(
                        lanes + bpt + s)).to(DEV)].contiguous() for s in (0, 1))
                g2 = K.bpr_stage2_plain(sm, sg, t_count, bpt, group)
                pairs.append(("bpr_stage2",
                              K.bpr_stage2(sm, sg, t_count, bpt, group), g2))
            pairs.append(("bpr_fold", K.bpr_fold(g2, windows_, t_count, group),
                          K.bpr_fold_plain(g2, windows_, t_count, group)))
    for name, got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for x, y in zip(got, want):
            cases.append((name + tag, x, y))
    # a small real plan: 2048 points, chunk 8, K = 2
    npts, chunk, windows = 2048, 8, 32
    points = rand_plane(rng, group.aff_rows, npts, p, nw)
    table = S.build_signed_table(points, group)
    sw = torch.tensor(
        [[rng.randrange(1 << 32) for _ in range(npts)] for _ in range(8)],
        dtype=torch.int64,
    )
    sw[7] &= (1 << 29) - 1
    digits = decompose_scalars_signed(sw.to(DEV), chunk, windows)
    plan = build_bucket_plan(digits, chunk)
    kn = plan.sorted_vals.shape[0]
    hp = T.build_hybrid_plan(plan.starts, plan.lens, kn, 2, windows)
    for last in (False, True):
        cases.append((
            "tree_level_aff" + tag,
            T.run_tree_level(table, hp.level_map1, "aff", last,
                             plan.sorted_vals, group),
            T.tree_level_plain(table, hp.level_map1, "aff", last,
                               plan.sorted_vals, group),
        ))
    lvl1 = T.run_tree_level(table, hp.level_map1, "aff",
                            sorted_vals=plan.sorted_vals, group=group)
    c1, s1 = T.chain_counts(hp.lens, 1)
    c2, s2 = T.chain_counts(hp.lens, 2)
    (_, cap2) = T.level_caps(kn, hp.lens.shape[0], 2)
    map2 = T.build_level_map(s1, c1, s2, c2, cap2)
    for last in (False, True):
        cases.append(("tree_level_full" + tag,
                      T.run_tree_level(lvl1, map2, "full", last, group=group),
                      T.tree_level_plain(lvl1, map2, "full", last,
                                         group=group)))
    cases.append(("tree_level_full" + tag,
                  T.run_tree_level(lvl1, map2, "full", group=group, rows=True),
                  T.tree_level_plain(lvl1, map2, "full", False, group=group,
                                     rows=True)))
    lvl2 = T.run_tree_level(lvl1, map2, "full", group=group, rows=True)
    cases.append(("packed_finish" + tag, S.packed_finish(lvl2, hp.layout, group),
                  S.packed_finish_plain(lvl2, hp.layout.starts_rk,
                                        hp.layout.lens_rk, group)))
    layout = S.build_stream_layout(plan.starts, plan.lens, windows)
    cases.append((
        "stream_buckets" + tag,
        S.accumulate_buckets_streamed(table, plan.sorted_vals, layout, group),
        S.accumulate_buckets_streamed_plain(table, plan.sorted_vals,
                                            layout.starts_rk, layout.lens_rk,
                                            group),
    ))
    return cases, points, plan, windows


def edge_lanes(group, a, b):
    """b with lane 0 the identity, lane 1 equal to a's and lane 2 a's
    inverse: the operands a complete add must take."""
    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C

    b = b.clone()
    b[:, 0] = C.merge(group.zero(1, a.device))[:, 0]
    b[:, 1] = a[:, 1]
    b[:, 2] = C.merge(group.neg(group.split(a[:, 2:3])))[:, 0]
    return b


def fold_cases(rng, group):
    """Phase 2: the fold on hand-made buckets of random canonical nodes:
    empty buckets, one piece, odd counts, counts about the fold block's 64
    threads and its 64 shared-memory nodes a level, and long buckets
    (1,000 and 2,048 pieces: the duplicate-heavy bucket of a forced fused
    run at 2^16), whose first levels live in the scratch plane."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_tree as T

    ctx = group.ctx
    counts = [0, 1, 2, 3, 5, 63, 64, 65, 127, 128, 129, 130, 257, 0, 1000,
              2048, 7] + [rng.randrange(9) for _ in range(240)]
    cols = sum(counts)
    sums = rand_plane(rng, group.rows, cols, ctx.p, ctx.nw)
    c = torch.tensor(counts, dtype=torch.int64, device=DEV)
    offsets = torch.cumsum(c, 0) - c
    caps = T.level_caps(cols, len(counts),
                        SK.fold_levels(max(counts), 1))
    got = SK.fold_pieces(sums, c, offsets, caps, group)[0]
    want = SK.fold_pieces_plain(sums, c, offsets, caps, group)[0]
    return [("fold_pieces" + ctx.tag, got, want)]


def canonical_kernel_cases(rng, group, points, plan, windows, n=4096):
    """Phase 2 for kernels 6, 7 and 8 of one curve: the fused path on the
    small real plan of lazy_kernel_cases (empty, short and long buckets):
    kernel 8 over its pieces, the fold, both passes in one dispatch and
    window by window against the same functions run with their plain
    forms (plain_passes), and kernel 8 on hand-made segments over random rows (empty,
    length 1, long, overlapping); kernel 6 (legacy_cases), the scalar
    multiplication (scalar_mult_cases), the tree sum (tree_cases) and the
    running sum over 1 and 3 steps on random canonical lanes, identity,
    equal and inverse operands among them."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK

    ctx, tag = group.ctx, group.ctx.tag
    nw, p = ctx.nw, ctx.p
    cases = []
    wide = SK.make_wide_rows(points, group)
    gathered = SK.pregather_signed(wide, plan.sorted_vals, group)
    npts = points.shape[1]
    if int(plan.lens.min()) != 0 or int(plan.lens.max()) <= 2 * SK.PIECE:
        raise SystemExit("the fused plan lacks an empty or a long bucket")
    pp = SK.piece_plan(plan.starts, plan.lens, gathered.shape[0], npts)
    sums = SK.fused_segments(gathered, pp.starts, pp.lens, group)
    name = "fused_buckets" + tag
    sums_plain = SK.accumulate_buckets_fused_plain(gathered, pp.starts,
                                                   pp.lens, group)
    cases.append((name, sums, sums_plain))
    # the plain form as phase 4 runs it (its round replayed from a CUDA
    # graph) against the plain form run eagerly
    cases.append((name, fused_plain_graphed(gathered, pp.starts, pp.lens,
                                            group), sums_plain))
    with plain_passes():
        want = SK.accumulate_buckets_fused(gathered, plan.starts, plan.lens,
                                           group, max_len=npts)
    cases.append(("fold_pieces" + tag, SK.fold_pieces(
        sums, pp.counts, pp.offsets, pp.caps, group)[0],
        SK.fold_pieces_plain(sums, pp.counts, pp.offsets, pp.caps, group)[0]))
    cases += fold_cases(rng, group)
    cases.append((name, SK.accumulate_buckets_fused(
        gathered, plan.starts, plan.lens, group, max_len=npts), want))
    # kernel 8 window by window, then one fold: a bucket's pieces fold in
    # the same pairs, the same words as one dispatch
    cases.append((name, SK.accumulate_buckets_windowed(
        wide, plan.sorted_vals, plan.starts, plan.lens, windows, group), want))
    rrows = torch.zeros((600, SK.ROW_WORDS), dtype=torch.int32, device=DEV)
    rrows[:, :group.aff_rows] = rand_plane(rng, group.aff_rows, 600, p, nw).T
    rlens = [0, 1, 2, 65, 0, 33, 1, 100] + [rng.randrange(9) for _ in range(992)]
    rstarts = [rng.randrange(600 - l + 1) for l in rlens]
    rstarts, rlens = (torch.tensor(v, dtype=torch.int32, device=DEV)
                      for v in (rstarts, rlens))
    cases.append((name, SK.fused_segments(rrows, rstarts, rlens, group),
                  SK.accumulate_buckets_fused_plain(rrows, rstarts, rlens,
                                                    group)))
    cases += legacy_cases(rng, group, points, plan, pp)
    cases += scalar_mult_cases(rng, group)
    cases += tree_cases(rng, group)
    # the running sum: operands below p, m with identity lanes, the
    # addends with identity, equal and inverse lanes
    ca, cg = (rand_plane(rng, group.rows, n, p, nw) for _ in range(2))
    ca = edge_lanes(group, cg, ca)
    walk = torch.cat([edge_lanes(group, ca, rand_plane(rng, group.rows, n, p,
                                                       nw))
                      for _ in range(3)], dim=1)
    for steps in (1, 3):
        steps_walk = walk[:, :steps * n].contiguous()
        got = K.running_sum(ca, cg, steps_walk, steps, group)
        want = K.running_sum_plain(ca, cg, steps_walk, steps, group)
        cases += [("running_sum" + tag, x, y) for x, y in zip(got, want)]
    return cases


def tree_cases(rng, group, widths=(512, 1 << 18)):
    """Phase 2 for the tree sum of one curve: widths 1 and 2, then
    `widths` (512: two blocks and the last block's finish; 2^18: a thread
    first folds four lanes on its own; phase 4 holds the naive call's
    2^16, 256 blocks), whose planes are random canonical
    lanes x, then x's edge lanes (the first level meets the identity, an
    equal and an inverse lane), x twice (every first-level add a
    doubling) or x's negation (the first level all identities); each
    plane's plain form run once and its kernel launched twice, as state
    left by the first launch would spoil the second."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K

    ctx, tag = group.ctx, group.ctx.tag
    planes = [rand_plane(rng, group.rows, w, ctx.p, ctx.nw) for w in (1, 2)]
    for width in widths:
        x = rand_plane(rng, group.rows, width // 2, ctx.p, ctx.nw)
        neg = C.merge(group.neg(group.split(x)))
        planes += [torch.cat([x, edge_lanes(group, x, x.flip(1))], dim=1),
                   torch.cat([x, x], dim=1), torch.cat([x, neg], dim=1)]
    cases = []
    for pts in planes:
        want = K.tree_sum_plain(pts, group)
        cases += [("tree_sum" + tag, K.tree_sum(pts, group), want)
                  for _ in range(2)]
    return cases


def legacy_cases(rng, group, points, plan, pp):
    """Phase 2 for kernel 6 of one curve: legacy_buckets over the signed
    table of the small real plan's points, on its whole buckets (empty
    and longer than a piece among them) and on its pieces (pp: at most
    PIECE entries), and on hand-made segments of a random entry stream with
    random signs (empty, length 1, 65, 97, overlapping)."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import buckets as B
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK

    name, npts = "legacy_buckets" + group.ctx.tag, points.shape[1]
    table = K.build_signed_table(points, group)
    if int(plan.lens.min()) != 0 or int(plan.lens.max()) <= SK.PIECE:
        raise SystemExit("the legacy plan lacks an empty or a long bucket")
    cases = [(name, B.legacy_buckets(table, plan.sorted_vals, s, ln, group),
              B.legacy_buckets_plain(table, plan.sorted_vals, s, ln, group))
             for s, ln in ((plan.starts, plan.lens), (pp.starts, pp.lens))]
    count = 3000
    vals = torch.tensor([rng.randrange(npts) | (rng.randrange(2) << 30)
                         for _ in range(count)], dtype=torch.int32, device=DEV)
    rlens = [0, 1, 2, 65, 0, 33, 1, 97] + [rng.randrange(9) for _ in range(992)]
    rstarts = [rng.randrange(count - ln + 1) for ln in rlens]
    rstarts, rlens = (torch.tensor(v, dtype=torch.int32, device=DEV)
                      for v in (rstarts, rlens))
    cases.append((name, B.legacy_buckets(table, vals, rstarts, rlens, group),
                  B.legacy_buckets_plain(table, vals, rstarts, rlens, group)))
    return cases


def scalar_mult_cases(rng, group, n=2048):
    """Phase 2 for kernel 7's scalar multiplication of one curve: random
    canonical affine lanes, scalars 0, 1, r - 1, 2^253 - 1, 2^256 - 1 and
    a lone top bit among random 256-bit ones, at bits 0, 1, 7 and 256
    (phase 4 holds the naive path's 253 bits)."""
    import numpy as np
    import torch

    from webgpu_msm_bls12_377_tpu_torch import params as PP
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K

    order = (PP.SCALAR_FIELD if group.ctx.tag == ""
             else PP.EDWARDS_SUBGROUP_CHARACTERISTIC)
    table = rand_plane(rng, group.aff_rows, n, group.ctx.p, group.ctx.nw)
    ks = [0, 1, order - 1, (1 << 253) - 1, (1 << 256) - 1, 1 << 255] + [
        rng.randrange(1 << 256) for _ in range(n - 6)]
    words = np.array([[(k >> (32 * i)) & 0xFFFFFFFF for k in ks]
                      for i in range(8)], dtype=np.uint32)
    sw = torch.from_numpy(words.view(np.int32)).to(DEV)
    return [("scalar_mult" + group.ctx.tag, K.scalar_mult(table, sw, bits, group),
             K.scalar_mult_plain(table, sw, bits, group))
            for bits in (0, 1, 7, 256)]


def check_kernels_random() -> None:
    """Phase 2: every entry point against its plain form, bit-exact, both
    curves."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C

    cases = []
    for group, seed in ((C.G1, "chip-smoke-kernels"),
                        (C.EDWARDS, "chip-smoke-kernels-ed")):
        rng = random.Random(seed)
        lazy, points, plan, windows = lazy_kernel_cases(rng, group)
        cases += lazy + canonical_kernel_cases(rng, group, points, plan,
                                               windows)
    torch.cuda.synchronize()
    bad = []
    for name, got, want in cases:
        err = max_abs_err(got, want)
        log(f"  kernel {name:27s} {tuple(got.shape)} vs plain: "
            f"max_abs_err {err}")
        if err:
            bad.append(name)
    seen = {c[0] for c in cases} - set(LANE_CHECKS)
    if bad or seen != set(KERNELS):
        raise SystemExit(f"kernel mismatch: {bad}, untested: {set(KERNELS) - seen}")


@contextlib.contextmanager
def plain_passes():
    """Inside the block the fused path's two passes run their plain forms
    on the card: kernel 8's (accumulate_buckets_fused_plain) and the
    fold's (fold_pieces_plain)."""
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK

    with patched([(SK, "fused_segments", SK.accumulate_buckets_fused_plain),
                  (SK, "fold_pieces", SK.fold_pieces_plain)]):
        yield


def fused_plain_graphed(gathered, starts, lens, group=None):
    """accumulate_buckets_fused_plain with its round (smvp_kernel.fused_round,
    thousands of small PyTorch ops) captured once in a CUDA graph and
    replayed once per entry of the longest segment: the same plain ops on
    the same operands in the same order, without the host's cost per op,
    which phase 4's forced fused run at 2^16 pays over 17 launches (18.4 s
    eagerly on an H100 80GB HBM3 at 700 W).  The capture is part of the
    call's time."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK

    group = group or C.G1
    starts, lens = starts.to(torch.int64), lens.to(torch.int64)
    rounds = int(lens.max()) if lens.numel() else 0
    zero = group.zero(starts.shape[0], gathered.device)
    acc = type(zero)(*(c.clone() for c in zero))
    t = torch.zeros((), dtype=torch.int64, device=gathered.device)
    if not rounds:
        return C.merge(acc)

    def step():
        new = SK.fused_round(acc, gathered, starts, lens, t, group)
        for a, b in zip(acc, new):
            a.copy_(b)
        t.add_(1)

    # one round on a side stream first (allocator, cached constants), as
    # graph capture asks; its effect is undone below
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for a, z in zip(acc, zero):
        a.copy_(z)
    t.zero_()
    for _ in range(rounds):
        graph.replay()
    return C.merge(acc)


def bench_case(power: int, curve: str = "bls12_377"):
    """The bench case's point, scalar and k words, made on DEV
    (harness/testdata.py:bench_words)."""
    return bench_words(power, curve, DEV)


#: bytes of one point in the reference's wire format, by wire path
WIRE = {"wire_tree": 96, "ed_wire_tree": 64}


class graphed:
    """A lane-wise plain form (no host reads, fixed shapes) with one call
    per argument signature captured in a CUDA graph and replayed for every
    call: the same plain ops on the same operands, without the host's cost
    per op (a plain form is thousands of small ops, and the naive path
    alone makes 256 calls).  prepare(*args) captures outside a timed call;
    a call copies its tensors into the graph's inputs, replays, and returns
    clones of the graph's outputs."""

    def __init__(self, plain):
        self.plain, self.graphs = plain, {}

    @staticmethod
    def _key(args):
        import torch

        return tuple((a.shape, a.dtype) if torch.is_tensor(a)
                     else a if isinstance(a, int) else id(a) for a in args)

    def prepare(self, *args):
        import torch

        key = self._key(args)
        if key not in self.graphs:
            static = [a.clone() if torch.is_tensor(a) else a for a in args]
            # one eager call on a side stream first (allocator, cached
            # constants), as graph capture asks
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.plain(*static)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self.plain(*static)
            self.graphs[key] = (graph, static, out)
        return self.graphs[key]

    def __call__(self, *args):
        import torch

        graph, static, out = self.prepare(*args)
        for s, a in zip(static, args):
            if torch.is_tensor(a):
                s.copy_(a)
        graph.replay()
        return (tuple(o.clone() for o in out) if isinstance(out, tuple)
                else out.clone())


def fenced(fn, *args):
    """fn(*args) between two device synchronizations; (result, seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn(*args)
    torch.cuda.synchronize()
    return got, time.perf_counter() - t0


def run_msm(pw, sw):
    from webgpu_msm_bls12_377_tpu_torch import compute_msm

    return fenced(compute_msm, pw, sw)


def run_ed_msm(pw, sw):
    from webgpu_msm_bls12_377_tpu_torch import compute_msm_edwards

    return fenced(compute_msm_edwards, pw, sw)


def engine_msm(**opts):
    """compute_msm of a CuzkMsmEngine with the given options."""
    def run(pw, sw):
        from webgpu_msm_bls12_377_tpu_torch.models import CuzkMsmEngine

        return CuzkMsmEngine(**opts).compute_msm(pw, sw)
    return run


def batch_msm(pw, sws, curve=None):
    """compute_msm_batch with default options (BLS12-377 unless a curve is
    given); the per-set stage runs with PyTorch's sync debug mode raising
    on any call that waits for the device."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.models import CuzkMsmEngine

    real = CuzkMsmEngine._batch_sets

    def strict(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    eng = CuzkMsmEngine() if curve is None else CuzkMsmEngine(curve)
    with patched([(CuzkMsmEngine, "_batch_sets", strict)]):
        return eng.compute_msm_batch(pw, sws)


def pippenger_msm(pw, sw, curve="bls12_377"):
    from webgpu_msm_bls12_377_tpu_torch.models import PippengerMsmEngine
    from webgpu_msm_bls12_377_tpu_torch.params import CurveId

    return PippengerMsmEngine(CurveId(curve)).compute_msm(pw, sw)


def to_affine(plane, curve, lane=0):
    """Lane of a canonical (39|36, n) plane (Montgomery or plain: the
    scale cancels) -> the oracle's affine {"x", "y"}."""
    from webgpu_msm_bls12_377_tpu_torch.ops import field as F
    from webgpu_msm_bls12_377_tpu_torch.reference import curve as ocurve

    nw = 13 if curve == "bls12_377" else 9
    coords = [F.plane_to_ints(plane[c * nw:(c + 1) * nw, lane:lane + 1])[0]
              for c in range(plane.shape[0] // nw)]
    if curve == "bls12_377":
        x, y = ocurve.g1_to_affine(ocurve.ProjectivePoint(*coords))
    else:
        x, y = ocurve.ed_to_affine(ocurve.ExtendedPoint(*coords))
    return {"x": x, "y": y}


def naive_msm(pw, sw, curve="bls12_377"):
    """NaiveMsmEngine's device function, then the affine result."""
    from webgpu_msm_bls12_377_tpu_torch.models import NaiveMsmEngine
    from webgpu_msm_bls12_377_tpu_torch.params import CurveId

    return to_affine(NaiveMsmEngine(CurveId(curve)).build_fn()(pw, sw), curve)


def same_points_on_card(a, b, group):
    """Two canonical projective planes hold the same points lane by lane:
    X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1 mod p (Z the last coordinate), with
    canonical Montgomery products on the card."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import field as F

    ctx, pa, pb = group.ctx, group.split(a), group.split(b)
    return all(torch.equal(F.mont_mul_canon(pa[c], pb[-1], ctx),
                           F.mont_mul_canon(pb[c], pa[-1], ctx))
               for c in (0, 1))


def running_sum_chain(pw, curve="bls12_377", steps=8):
    """`steps` canonical running-sum steps over all points of a case
    (their Montgomery table from the point prep), from the identity, with
    b_t the table rolled by t lanes: the step-major walk of the b_t, then
    one running_sum launch over it; BPR stage 1 over the same walk (bpt =
    steps, a lane a point, the engine's split) must give the same points
    as g.  Returns lane 0 of g as the affine {"x", "y"}."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import words_to_device
    from webgpu_msm_bls12_377_tpu_torch.ops import bpr
    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops.convert import WireLayout
    from webgpu_msm_bls12_377_tpu_torch.params import CurveId

    group = C.group_ops(CurveId(curve))
    layout = WireLayout.of(pw, False, group.ctx.nw - 1, 2)
    table = K.point_prep(words_to_device(pw, torch.device(DEV)), layout,
                         group, K.PLANE)
    pts = C.merge(group.from_affine(group.split_aff(table)))
    lanes = pts.shape[1]
    zero = C.merge(group.zero(lanes, DEV))
    walk = torch.cat([torch.roll(pts, t, dims=1) for t in range(steps)],
                     dim=1)
    _, g = K.running_sum(zero, zero, walk, steps, group)
    _, lg = K.bpr_stage1(walk, steps, bpr.stage1_split(lanes, steps, group),
                         group)
    lazy = C.merge(group.canon(group.split(lg)))
    if not same_points_on_card(g, lazy, group):
        raise SystemExit("running-sum chain: the canonical steps and BPR "
                         "stage 1 give other points")
    # Montgomery coordinates are the plain ones scaled by R: the same
    # projective point
    return to_affine(g, curve)


def running_sum_oracle(pw, curve="bls12_377", steps=8):
    """Lane 0 of running_sum_chain with Python integers: step t adds point
    (-t mod n) to m and m to g, so g = sum_t (steps - t) * P[-t]."""
    from webgpu_msm_bls12_377_tpu_torch.reference import curve as ocurve

    g1 = curve == "bls12_377"
    from_affine, add, mult, to_aff, zero = (
        (ocurve.g1_from_affine, ocurve.g1_add, ocurve.g1_scalar_mult,
         ocurve.g1_to_affine, ocurve.G1_ZERO) if g1 else
        (ocurve.ed_from_affine, ocurve.ed_add, ocurve.ed_scalar_mult,
         ocurve.ed_to_affine, ocurve.ED_ZERO))

    def point(i):
        return from_affine(*(
            sum(int(w) << (32 * j) for j, w in enumerate(pw[c, :, i]))
            for c in range(2)))

    g = zero
    for t in range(steps):
        g = add(g, mult(point(-t), steps - t))
    x, y = to_aff(g)
    return {"x": x, "y": y}


def drive(label, path, fn, args, want, warm_runs=3):
    """Phase 3 for one case: counts zeroed just before the cold run and
    read just after; the result against `want` (the pinned golden, or the
    oracle's result); warm_runs warm runs.  Returns the launches of the
    cold run and the warm median in seconds."""
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K

    K.reset_launches()
    got, cold = fenced(fn, *args)
    launches = dict(K.launches)
    if got != want:
        raise SystemExit(f"{label}: result differs from the expected one")
    warm = []
    for _ in range(warm_runs):
        again, dt = fenced(fn, *args)
        if again != want:
            raise SystemExit(f"{label}: warm result differs")
        warm.append(dt)
    med = statistics.median(warm)
    pts = args[0]
    n = (pts.shape[-1] if hasattr(pts, "shape") else len(pts) // WIRE[path]) * (
        len(want) if isinstance(want, list) else 1)
    log(f"  {label}: result OK; cold {cold:.3f} s, warm median {med:.4f} s "
        f"({[round(w, 4) for w in warm]}), {n / med:,.0f} points/s")
    log(f"  {label} launches per run: {launches}")
    missing = set(PATHS[path]) - {k for k, v in launches.items() if v}
    if missing:
        raise SystemExit(f"{label}: kernels not launched: {missing}")
    # the point prep, the legacy SMVP and the scalar multiplication are
    # one launch a run
    for name in {k + tag for k in ONCE for tag in ("", "_ed")} & set(
            PATHS[path]):
        if launches[name] != 1:
            raise SystemExit(f"{label}: {name} launched {launches[name]} "
                             "times, not once")
    # a BPR reduction is stage 1 (where bpt > 1), stage 2 and the fold, one
    # launch each, once a scalar set (the chain runs stage 1 alone, no
    # reduction)
    sets = len(want) if isinstance(want, list) else 1
    for tag in ("", "_ed") if "running_sum" not in path else ():
        s1, s2, fold = (launches.get(k + tag, 0) for k in BPR)
        if (s2 != fold or s1 > s2 or launches.get("bpr_add" + tag) or (
                s2 and s2 != sets)):
            raise SystemExit(f"{label}: BPR launched stage 1 {s1}, stage 2 "
                             f"{s2} and the fold {fold} times for {sets} "
                             "scalar sets")
    return launches, med


def main_paths(goldens):
    """Phase 3; returns the launch counts by path (of the largest case of
    each path), the inputs by power, the batch scalar sets and the warm
    medians by path."""
    from webgpu_msm_bls12_377_tpu_torch import compute_msm
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine
    from webgpu_msm_bls12_377_tpu_torch.ops.decompose import (
        choose_chunk_size,
        num_windows_for,
    )

    def golden(key):
        x_hex, y_hex = goldens[f"bls12_377:{key}"][:2]
        return {"x": int(x_hex, 16), "y": int(y_hex, 16)}

    counts, inputs, medians = {}, {}, {}

    def run(path, label, fn, args, want, **kw):
        counts[path], medians[path] = drive(label, path, fn, args, want, **kw)

    auto = CuzkMsmEngine()
    for power, chunk in BENCH:
        t0 = time.perf_counter()
        pw, sw, _ = bench_case(power)
        inputs[power] = pw, sw
        log(f"  2^{power}: bench inputs built on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        want = golden(f"{power}:bench-{power}")
        path = auto._select_smvp(chunk, 1 << power)
        if choose_chunk_size(1 << power) != chunk or path != (
                "tree" if power >= 18 else "stream" if power >= 16 else "fused"):
            raise SystemExit(f"2^{power}: the default policy gives chunk "
                             f"{choose_chunk_size(1 << power)}, path {path}")
        run("fused_10" if power == 10 else path,
            f"2^{power} compute_msm ({path}, chunk {chunk})",
            compute_msm, (pw, sw), want)
        if power == 20:
            run("wire_tree", "2^20 compute_msm from wire bytes (tree)",
                compute_msm, to_wire(pw, sw), want)
        if power == 14:
            # what the default policy passes over at this size: kernel 6
            # over pieces and the fold (one warm run), and kernel 5
            run("legacy_14", "2^14 compute_msm (legacy forced, chunk 4)",
                engine_msm(smvp_mode="legacy"), (pw, sw), want, warm_runs=1)
            for forced in FORCED_14:
                run("stream_14",
                    f"2^14 compute_msm (stream forced, chunk {forced})",
                    engine_msm(smvp_mode="stream", chunk_size=forced),
                    (pw, sw), want)
        if power == 16:
            run("fused_forced",
                f"2^16 compute_msm (fused forced, chunk {FORCED_CHUNK})",
                engine_msm(smvp_mode="fused", chunk_size=FORCED_CHUNK),
                (pw, sw), want)
            if counts["fused_forced"]["fused_buckets"] != num_windows_for(
                    FORCED_CHUNK):
                raise SystemExit("forced fused at chunk 15: not one launch "
                                 "of the fused kernel per window")
            run("legacy", "2^16 PippengerMsmEngine (legacy)", pippenger_msm,
                (pw, sw), want)
            run("naive", "2^16 NaiveMsmEngine", naive_msm, (pw, sw), want)
            run("running_sum", "2^16 running-sum chain", running_sum_chain,
                (pw,), running_sum_oracle(pw))
        if power == 18:
            run("pure_tree", "2^18 compute_msm (pure tree forced, chunk 15)",
                engine_msm(smvp_mode="tree"), (pw, sw), want)
            if (counts["pure_tree"]["tree_level_full"] < 2
                    or counts["pure_tree"].get("packed_finish")):
                raise SystemExit("the pure tree must run several full levels "
                                 "and no packed finish")
    # batches over a fixed point set: the point prep once, a Montgomery
    # exit per set
    t0 = time.perf_counter()
    sets = {20: batch_scalars(20, BATCH_SETS),
            17: batch_scalars(17, STREAM_BATCH_SETS)}
    log(f"  batch scalar sets drawn in {time.perf_counter() - t0:.1f} s")
    run("batch_tree", f"2^20 compute_msm_batch ({BATCH_SETS} sets, tree)",
        batch_msm, (inputs[20][0], sets[20]),
        [golden(f"20:bench-20:batch{i}") for i in range(BATCH_SETS)])
    singles = [compute_msm(inputs[17][0], sw) for sw in sets[17]]
    run("batch_stream", f"2^17 compute_msm_batch ({STREAM_BATCH_SETS} sets, "
        "stream)", batch_msm, (inputs[17][0], sets[17]), singles)
    for path, num in (("batch_tree", BATCH_SETS),
                      ("batch_stream", STREAM_BATCH_SETS)):
        got = tuple(counts[path][k] for k in PREP)
        if got != (1, num):
            raise SystemExit(f"{path}: kernel 1's entry and exit ran {got} "
                             f"times, not once for the points and once per "
                             "set")
    log(f"  2^20 batch: {medians['batch_tree'] / BATCH_SETS:.4f} s per set "
        f"(warm median of the batch / {BATCH_SETS}) beside "
        f"{medians['tree']:.4f} s for one warm compute_msm")
    log(f"  2^17 batch: {medians['batch_stream'] / STREAM_BATCH_SETS:.4f} s "
        f"per set beside {medians['stream']:.4f} s for one warm compute_msm")
    covered = {k for names in PATHS.values() for k in names}
    if covered != set(KERNELS):
        raise SystemExit(f"no path names {set(KERNELS) - covered}")
    return counts, inputs, sets, medians


def edwards_paths(goldens, counts, medians):
    """Phase 3 for Twisted Edwards BLS12: compute_msm_edwards at the
    default policy's fused (2^10, 2^14), stream (2^16, 2^17) and
    hybrid-tree (2^18, 2^20) sizes; the 2^14 case forced through legacy;
    PippengerMsmEngine, NaiveMsmEngine and the running-sum chain at 2^16;
    the pure tree forced at 2^18; compute_msm_batch of 8 sets at 2^20.
    From 2^16 the results are held against the pinned edwards_bls12
    goldens; below, where none is pinned, against msm_oracle, which first
    reproduces the 2^16 golden.  Returns the inputs by power and the
    batch's scalar sets; adds to counts and medians by path."""
    from webgpu_msm_bls12_377_tpu_torch import compute_msm_edwards
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine
    from webgpu_msm_bls12_377_tpu_torch.ops.decompose import choose_chunk_size
    from webgpu_msm_bls12_377_tpu_torch.params import CurveId

    ed = CurveId.EDWARDS_BLS12

    def golden(key):
        x_hex, y_hex = goldens[f"edwards_bls12:{key}"][:2]
        return {"x": int(x_hex, 16), "y": int(y_hex, 16)}

    def run(path, label, fn, args, want, **kw):
        counts[path], medians[path] = drive(label, path, fn, args, want, **kw)

    auto = CuzkMsmEngine(ed)
    inputs, cases = {}, {}
    for power, _ in BENCH:
        t0 = time.perf_counter()
        cases[power] = bench_case(power, ED)
        inputs[power] = cases[power][:2]
        log(f"  Edwards 2^{power}: bench inputs built on the card in "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if msm_oracle(*cases[16][1:], ED) != golden("16:bench-16"):
        raise SystemExit("Edwards: the oracle misses the 2^16 golden")
    log(f"  Edwards oracle (sum of s_i k_i mod r) * G reproduces the 2^16 "
        f"golden ({time.perf_counter() - t0:.1f} s)")
    for power, chunk in BENCH:
        pw, sw = inputs[power]
        want = (golden(f"{power}:bench-{power}") if power >= 16
                else msm_oracle(*cases[power][1:], ED))
        path = auto._select_smvp(chunk, 1 << power)
        if choose_chunk_size(1 << power) != chunk or path != (
                "tree" if power >= 18 else "stream" if power >= 16 else "fused"):
            raise SystemExit(f"Edwards 2^{power}: the default policy gives "
                             f"chunk {choose_chunk_size(1 << power)}, path {path}")
        run("ed_fused_10" if power == 10 else f"ed_{path}",
            f"Edwards 2^{power} compute_msm_edwards ({path}, chunk {chunk})",
            compute_msm_edwards, (pw, sw), want)
        if power == 20:
            run("ed_wire_tree",
                "Edwards 2^20 compute_msm_edwards from wire bytes (tree)",
                compute_msm_edwards, to_wire(pw, sw), want)
        if power == 14:
            run("ed_legacy_14", "Edwards 2^14 (legacy forced, chunk 4)",
                engine_msm(curve=ed, smvp_mode="legacy"), (pw, sw), want,
                warm_runs=1)
        if power == 16:
            run("ed_legacy", "Edwards 2^16 PippengerMsmEngine (legacy)",
                pippenger_msm, (pw, sw, ED), want)
            run("ed_naive", "Edwards 2^16 NaiveMsmEngine", naive_msm,
                (pw, sw, ED), want)
            run("ed_running_sum", "Edwards 2^16 running-sum chain",
                running_sum_chain, (pw, ED), running_sum_oracle(pw, ED))
        if power == 18:
            run("ed_pure_tree", "Edwards 2^18 (pure tree forced, chunk 15)",
                engine_msm(curve=ed, smvp_mode="tree"), (pw, sw), want)
    t0 = time.perf_counter()
    sets = batch_scalars(20, BATCH_SETS, ED)
    log(f"  Edwards batch scalar sets drawn in {time.perf_counter() - t0:.1f} s")
    run("ed_batch_tree", f"Edwards 2^20 compute_msm_batch ({BATCH_SETS} sets, "
        "tree)", lambda pw, sws: batch_msm(pw, sws, ed), (inputs[20][0], sets),
        [golden(f"20:bench-20:batch{i}") for i in range(BATCH_SETS)])
    # the point prep once, a Montgomery exit per set
    got = counts["ed_batch_tree"]
    if tuple(got[k] for k in PREP_ED) != (1, BATCH_SETS):
        raise SystemExit(f"Edwards batch: kernel 1 ran {got}")
    log(f"  Edwards 2^20 batch: {medians['ed_batch_tree'] / BATCH_SETS:.4f} s "
        f"per set beside {medians['ed_tree']:.4f} s for one warm "
        "compute_msm_edwards")
    return inputs, sets


#: the zipf cases of phase 3: (power, path); a pool of 2^ZIPF_POOL_BITS
#: scalars, alpha 1.2
ZIPF = ((20, "tree"), (17, "stream"))
ZIPF_POOL_BITS = 8
#: phase 3's run of the bench CLI
BENCH_ARGS = ("--n", "65536", "--runs", "2", "--prewarm")
DEBUG_STAGES = ("stage1_mont_convert", "stage2_transpose", "stage3_buckets")


def harness_runs(inputs, ed_inputs, medians):
    """Phase 3 for the harness: the zipf cases (make_zipf_case, pool
    2^ZIPF_POOL_BITS) at 2^20 (hybrid tree) and 2^17 (stream), both
    curves, through compute_msm against the known-k oracle (cold and 3
    warm), each warm median beside the uniform case's of the same n;
    debug_check at 2^17, both curves, every stage True; bench_torch.py
    in a subprocess, its last line a checked JSON result."""
    from webgpu_msm_bls12_377_tpu_torch import compute_msm, compute_msm_edwards
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine
    from webgpu_msm_bls12_377_tpu_torch.ops.buckets import build_bucket_plan
    from webgpu_msm_bls12_377_tpu_torch.ops.decompose import (
        choose_chunk_size,
        decompose_scalars_signed,
        num_windows_for,
    )
    from webgpu_msm_bls12_377_tpu_torch.params import CurveId
    import torch

    for curve, fn, pre in (("bls12_377", compute_msm, ""),
                           (ED, compute_msm_edwards, "ed_")):
        for power, path in ZIPF:
            t0 = time.perf_counter()
            case = make_zipf_case(curve, power, ZIPF_POOL_BITS, device=DEV)
            chunk = choose_chunk_size(1 << power)
            plan = build_bucket_plan(decompose_scalars_signed(
                torch.from_numpy(case.scalar_words.view("int32")).to(DEV),
                chunk, num_windows_for(chunk)), chunk)
            log(f"  {curve} 2^{power} zipf case made in "
                f"{time.perf_counter() - t0:.1f} s; longest bucket "
                f"{int(plan.lens.max())} entries, "
                f"{int((plan.lens > 0).sum())} nonempty buckets")
            _, med = drive(
                f"{curve} 2^{power} zipf (pool 2^{ZIPF_POOL_BITS}) "
                f"compute_msm ({path})", pre + path, fn,
                (case.point_words, case.scalar_words),
                dict(zip("xy", case.expected)))
            uniform = medians[pre + path]
            log(f"  {curve} 2^{power} warm median zipf / uniform: {med:.4f} "
                f"/ {uniform:.4f} s = {med / uniform:.2f}x")
    for curve, (pw, sw) in (("bls12_377", inputs[17]), (ED, ed_inputs[17])):
        t0 = time.perf_counter()
        checks = CuzkMsmEngine(CurveId(curve)).debug_check(pw, sw)
        if checks != dict.fromkeys(DEBUG_STAGES, True):
            raise SystemExit(f"{curve} 2^17 debug_check: {checks}")
        log(f"  {curve} 2^17 debug_check: {checks} in "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"),
                          *BENCH_ARGS], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    for line in out.stdout.splitlines():
        log(f"  bench_torch.py: {line}")
    if out.returncode:
        raise SystemExit(f"bench_torch.py {' '.join(BENCH_ARGS)} exited "
                         f"{out.returncode}: {out.stderr[-3000:]}")
    detail = json.loads(out.stdout.strip().splitlines()[-1])["detail"]
    if not detail["checked"] or detail["device"] != "cuda":
        raise SystemExit(f"bench_torch.py: an unchecked result: {detail}")
    log(f"  bench_torch.py {' '.join(BENCH_ARGS)}: ran in "
        f"{time.perf_counter() - t0:.1f} s")


#: the harness's second step: autotune's (curve, power) classes, the
#: static policy each is held against ((chunk, path, K) by power), the
#: sweep's powers (G1, one warm run each), and the microbench's lanes and
#: timed calls an operation
TUNE = (("bls12_377", 20), (ED, 20), ("bls12_377", 16))
STATIC = {20: (16, "tree", 2), 16: (15, "stream", 2)}
SWEEP_POWERS = (16, 20)
MICRO_LANES, MICRO_ITERS = 1 << 19, 5


@contextlib.contextmanager
def tuning_table(directory):
    """Inside the block the engines' tuning table is the one in
    `directory` (MSM_AUTOTUNE_DIR); after it, the script's empty one."""
    saved = os.environ["MSM_AUTOTUNE_DIR"]
    os.environ["MSM_AUTOTUNE_DIR"] = directory
    try:
        yield
    finally:
        os.environ["MSM_AUTOTUNE_DIR"] = saved


def harness2_runs(goldens, inputs, ed_inputs, tuned_dir, variant_build):
    """Phase 3, the harness's second part:
    - autotune (harness/autotune.py) on a table in tuned_dir:
      autotune_chunk (13, 15, 16) and then autotune_smvp (stream, K = 1,
      2, 3, at the tuned chunk) for each class of TUNE, on phase 3's
      cases (measure_fn: the inputs staged once, a cold run held against
      the golden, 2 warm runs, the best kept); every candidate's time and
      the winners against the static policy logged; then an engine with
      the default autotune=True over that table must resolve the winners
      (_chunk_for, _select_smvp, _tree_k) and give the golden;
    - the sweep (harness/sweep.py run_power) at SWEEP_POWERS with the
      script's empty table: every row verified, the Markdown table logged;
    - the microbench (harness/microbench.py): run() at MICRO_LANES lanes
      and product_study() (the carry chain and the -DMSM_MONT_C build of
      tree.cu, built in the background since phase 1: variant_build),
      both curves.
    Returns the carry chain's word-product rate by library tag (phase 4's
    integer bound)."""
    from types import SimpleNamespace

    from webgpu_msm_bls12_377_tpu_torch.harness import (
        autotune,
        microbench,
        sweep,
    )
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine
    from webgpu_msm_bls12_377_tpu_torch.params import CurveId

    with tuning_table(tuned_dir):
        for curve, power in TUNE:
            cid, n = CurveId(curve), 1 << power
            pw, sw = (ed_inputs if curve == ED else inputs)[power]
            x_hex, y_hex = goldens[f"{curve}:{power}:bench-{power}"][:2]
            want = {"x": int(x_hex, 16), "y": int(y_hex, 16)}
            case = SimpleNamespace(point_words=pw, scalar_words=sw,
                                   expected=(want["x"], want["y"]))

            def measure(engine_cls, curve_, n_, chunk, runs):
                return autotune._timed_runs(
                    engine_cls(curve_, chunk_size=chunk, autotune=False),
                    case, chunk, runs, f"{curve} 2^{power} chunk {chunk}")

            def measure_smvp(curve_, n_, chunk, smvp, k, runs):
                return autotune._timed_runs(
                    CuzkMsmEngine(curve_, chunk_size=chunk, smvp_mode=smvp,
                                  tree_finish=k, autotune=False),
                    case, chunk, runs, f"{curve} 2^{power} {smvp} K={k}")

            t0 = time.perf_counter()
            chunk = autotune.autotune_chunk(
                cid, n, candidates=autotune.DEFAULT_CANDIDATES,
                measure_fn=measure)
            mode, k = autotune.autotune_smvp(
                cid, n, candidates=autotune.SMVP_CANDIDATES,
                measure_fn=measure_smvp)
            entry = autotune.lookup_entry(cid, n)
            log(f"  autotune {curve} 2^{power} in "
                f"{time.perf_counter() - t0:.1f} s: best warm s by chunk "
                f"{entry['warm_s']}, by path at chunk {chunk} "
                f"{entry['smvp_warm_s']}")
            static = STATIC[power]
            won = (chunk, mode, k or 2)
            log(f"  autotune {curve} 2^{power}: winner chunk {chunk}, "
                f"{mode}, K {k} against the static policy chunk {static[0]}"
                f", {static[1]}, K {static[2]}: "
                + ("the static policy wins" if won == static else
                   "the static policy loses"))
            eng = CuzkMsmEngine(cid)
            got = (eng._chunk_for(n), eng._select_smvp(chunk, n),
                   eng._tree_k(n))
            if got != won:
                raise SystemExit(f"autotune {curve} 2^{power}: the engine "
                                 f"resolves {got} from the table, not {won}")
            result, secs = fenced(eng.compute_msm, pw, sw)
            if result != want:
                raise SystemExit(f"autotune {curve} 2^{power}: the tuned "
                                 "engine's result differs from the golden")
            log(f"  tuned engine {curve} 2^{power} ({got}): the golden, in "
                f"{secs:.4f} s")
    eng = CuzkMsmEngine()
    rows = []
    for power in SWEEP_POWERS:
        row = sweep.run_power(eng, CurveId.BLS12_377, power, 1)
        log(f"  sweep: {json.dumps(row)}")
        if row["verified"] is not True:
            raise SystemExit(f"sweep 2^{power}: not verified")
        rows.append(row)
    for line in sweep.markdown_table(rows).splitlines():
        log(f"  {line}")
    for curve in ("bls12_377", ED):
        out = microbench.run(CurveId(curve), MICRO_LANES, MICRO_ITERS)
        for name, row in out.items():
            if isinstance(row, dict):
                log(f"  microbench {curve} {name:25s} {row['ms']:10.3f} ms "
                    f"{row['M_ops_per_s']:10.2f} M/s  ({row['entry']})")
    t0 = time.perf_counter()
    variant_build.result()
    log(f"  the -DMSM_MONT_C build of tree.cu: waited "
        f"{time.perf_counter() - t0:.1f} s for it")
    rates = {}
    for curve in ("bls12_377", ED):
        study = microbench.product_study(CurveId(curve))
        for form, row in study["forms"].items():
            log(f"  product study {curve} ({study['num_words']} words), "
                f"{form}: {row['word_products_per_s']:.4e} word products/s, "
                f"{row['ns_per_product']:.4f} ns a Montgomery product "
                f"({study['blocks']} blocks of {study['threads']} threads, "
                f"{study['iters']} products each; {row['ms']:.3f} ms, "
                f"{[round(t, 3) for t in row['times_ms']]}); the "
                f"float32-rate yardstick {PEAK_MULS:.4e} /s")
        chain, c_form = (study["forms"][f]["word_products_per_s"]
                         for f in ("chain", "c_form"))
        log(f"  product study {curve}: the C form at {c_form / chain:.3f}x "
            "the carry chain's rate")
        rates["" if curve == "bls12_377" else "_ed"] = chain
    return rates


def timed_paths(inputs, ed_inputs):
    """Phase 4: each kernel launch of one run of every path timed,
    repeated with its plain form, compared, and its work counted.
    Returns stats[path][kernel]."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.models import cuzk, naive
    from webgpu_msm_bls12_377_tpu_torch.ops import bpr, buckets
    from webgpu_msm_bls12_377_tpu_torch.ops import field as F
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops.curve import G1
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_tree as T

    stats = {}
    current = {}
    replays = []  # the graphed plain forms

    def timed(fn, *args):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn(*args)
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    def record(name, kern, plain, args, muls, nbytes):
        """Time kern(*args) and plain(*args) and compare them (a graphed
        plain form is captured after the kernel's timed launch)."""
        got, ms = timed(kern, *args)
        if isinstance(plain, graphed):
            plain.prepare(*args)
        want, pms = timed(plain, *args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        s = current.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "err": 0,
                                      "muls": 0, "bytes": 0})
        s["ms"] += ms
        s["plain_ms"] += pms
        s["err"] = max([s["err"]] + [max_abs_err(x, y) for x, y in zip(got, want)])
        s["muls"] += muls
        s["bytes"] += nbytes
        return got if len(got) > 1 else got[0]

    def mmc(a, y, ctx=F.G1_CTX):
        n, w = a.numel() // ctx.nw, WORK[ctx.tag]
        return record("mont_mul_const" + ctx.tag, K_MMC, MMC_PLAIN,
                      (a, y, ctx), n * w["mm"],
                      2 * 4 * w["cw"] * n)

    def prep(words, layout, group=G1, out=K.SIGNED):
        # a point's x and y read once (cw words each), its form written
        # once: two 128-byte signed-table rows, or its column of the
        # (26|27, N) table; a product a coordinate of the table (Edwards:
        # x, y and t = x*y)
        w, n, tag = WORK[group.ctx.tag], layout.n, group.ctx.tag
        out_bytes = 2 * 4 * K.ROW_WORDS if out == K.SIGNED else 4 * group.aff_rows
        return record("point_prep" + tag, K_PREP, PREP_PLAIN,
                      (words, layout, group, out),
                      n * (group.aff_rows // group.ctx.nw) * w["mm"],
                      n * (2 * 4 * w["cw"] + out_bytes))

    def tree(arr_in, level_map, mode, last=False, sorted_vals=None, group=G1,
             rows=False):
        w = WORK[group.ctx.tag]
        m = level_map.to(torch.int64)
        invalid = (m & T.FLAG_INVALID) != 0
        single = ((m & T.FLAG_SINGLE) != 0) & ~invalid
        pairs = int((~invalid & ~single).sum())
        reads = 2 * pairs + int(single.sum())
        t = m.shape[0]
        if mode == "aff":
            muls = pairs * w["add_aff"]
            nbytes = reads * (4 + w["aff"]) + t * (4 + w["pt"])
        else:
            muls, nbytes = pairs * w["add_full"], reads * w["pt"] + t * (4 + w["pt"])
        return record(f"tree_level_{mode}" + group.ctx.tag, K_TREE,
                      T.tree_level_plain,
                      (arr_in, level_map, mode, last, sorted_vals, group, rows),
                      muls, nbytes)

    def bucket_work(lens, add_muls, entry_bytes, pt):
        # a bucket of c entries needs c - 1 adds (the kernel's first add,
        # into the identity, is not part of the function)
        entries, nb = int(lens.sum()), lens.numel()
        adds = int((lens.to(torch.int64) - 1).clamp(min=0).sum())
        return adds * add_muls, entries * entry_bytes + nb * (8 + pt)

    def finish(rows, layout, group=G1):
        w = WORK[group.ctx.tag]
        return record(
            "packed_finish" + group.ctx.tag,
            lambda r, s, l, g: K_FINISH(r, layout, g),
            S.packed_finish_plain,
            (rows, layout.starts_rk, layout.lens_rk, group),
            *bucket_work(layout.lens_rk, w["add_full"], w["pt"], w["pt"]))

    def stage1(buckets, bpt, split, group=G1):
        # the function's work: a lane's bpt - 1 running adds (two full adds
        # each, as the unsplit walk), every step's bucket read once, m and
        # g written once; the plain form runs eagerly (one call a path: a
        # CUDA graph would be captured for a single replay)
        w, lanes = WORK[group.ctx.tag], buckets.shape[1] // bpt
        return record("bpr_stage1" + group.ctx.tag, K_STAGE1,
                      K.bpr_stage1_plain,
                      (buckets, bpt, split, group),
                      2 * (bpt - 1) * lanes * w["add_full"],
                      (bpt + 2) * lanes * w["pt"])

    def stage2(m, g, t_count, bpt, group=G1):
        # a lane's b + bitlen(k) - 1 lazy doublings and popcount(k) adds,
        # k = t_count - 1 - t (nothing where k = 0); g read and written,
        # m read where k > 0
        w, lanes = WORK[group.ctx.tag], m.shape[1]
        k = [t_count - 1 - t for t in range(t_count)]
        per = lanes // t_count
        b = bpt.bit_length() - 1
        dbl = per * sum(b + x.bit_length() - 1 for x in k if x)
        adds = per * sum(bin(x).count("1") for x in k)
        return record("bpr_stage2" + group.ctx.tag, K_STAGE2,
                      K.bpr_stage2_plain, (m, g, t_count, bpt, group),
                      dbl * w["dbl"] + adds * w["add_full"],
                      (2 * lanes + per * sum(1 for x in k if x)) * w["pt"])

    def fold(g, num_windows, t_count, group=G1):
        # t_count - 1 lazy adds a window; every lane read once, a window
        # sum written
        w = WORK[group.ctx.tag]
        return record("bpr_fold" + group.ctx.tag, K_BFOLD, K.bpr_fold_plain,
                      (g, num_windows, t_count, group),
                      num_windows * (t_count - 1) * w["add_full"],
                      num_windows * (t_count + 1) * w["pt"])

    def stream(table, sorted_vals, layout, group=G1):
        w = WORK[group.ctx.tag]
        out = record(
            "stream_buckets" + group.ctx.tag,
            lambda t, v, s, l, g: K_STREAM(t, v, layout, g),
            S.accumulate_buckets_streamed_plain,
            (table, sorted_vals, layout.starts_rk, layout.lens_rk, group),
            *bucket_work(layout.lens_rk, w["add_mixed"], 4 + w["aff"], w["pt"]))
        # the spread of one launch on the same operands
        again = [round(timed(K_STREAM, table, sorted_vals, layout, group)[1], 3)
                 for _ in range(5)]
        log(f"  stream_buckets{group.ctx.tag}: five more launches {again} ms")
        return out

    def foldk(sums, counts, offsets, caps, group=G1):
        # a bucket of c pieces needs c - 1 full adds; every piece read
        # once, counts and offsets read and a node written per bucket
        w, c = WORK[group.ctx.tag], counts.to(torch.int64)
        adds = int((c - 1).clamp(min=0).sum())
        return record("fold_pieces" + group.ctx.tag, K_FOLD,
                      SK.fold_pieces_plain, (sums, counts, offsets, caps, group),
                      adds * w["add_full"],
                      int(c.sum()) * w["pt"] + c.numel() * (8 + w["pt"]))

    def fusedk(gathered, starts, lens, group=G1):
        # kernel 8 over the pieces: every entry is one canonical mixed add,
        # the one into the identity included (the function's result is
        # that add chain's coordinates); the fold is tree.cu's
        w, tag = WORK[group.ctx.tag], group.ctx.tag
        entries = int(lens.sum())
        log(f"  fused_buckets{tag}: {lens.numel()} piece slots, {entries} "
            f"entries, the longest piece {int(lens.max())}")
        return record("fused_buckets" + tag, K_FUSED, fused_plain_graphed,
                      (gathered, starts, lens, group),
                      entries * w["add_mixed_canon"],
                      entries * ROW + lens.numel() * (8 + w["pt"]))

    def lanes(fn, plain, name, arity, muls, nbytes):
        """Recorder for a lane-wise kernel of `arity` plane arguments and,
        for the kernels both curves build, the group after them:
        muls(n, w, *args) and nbytes(n, w, *args) with w the curve's WORK.
        Its plain form is replayed from CUDA graphs."""
        plain = graphed(plain)
        replays.append(plain)

        def run(*args):
            group = args[arity] if len(args) > arity else G1
            w, n = WORK[group.ctx.tag], args[0].shape[1]
            planes = args[:arity]
            return record(name + group.ctx.tag, fn, plain, args,
                          muls(n, w, *planes), nbytes(n, w, *planes))
        return run

    def legacyk(table, sorted_vals, starts, lens, group=G1):
        # every entry of a segment is one canonical mixed add, the one into
        # the identity included (the function's result is that chain's
        # coordinates); an entry's index and its row read once, a
        # segment's start, length and sum; the plain form (lockstep
        # rounds up to the longest segment, read back) runs eagerly
        w = WORK[group.ctx.tag]
        entries = int(lens.sum())
        log(f"  legacy_buckets{group.ctx.tag}: {lens.numel()} segments, "
            f"{entries} entries, the longest {int(lens.max())}")
        return record("legacy_buckets" + group.ctx.tag, K_LEGACY,
                      buckets.legacy_buckets_plain,
                      (table, sorted_vals, starts, lens, group),
                      entries * w["add_mixed_canon"],
                      entries * (ROW + 4) + lens.numel() * (8 + w["pt"]))

    def smult(table, scalars, bits, group=G1):
        # what the data needs: popcount(k) canonical adds and bitlen(k) - 1
        # doublings a lane (k cut to its low bits bits); a lane's point
        # and scalar read once and r written once; the plain form (bits
        # one-step plain forms) runs eagerly
        w, n = WORK[group.ctx.tag], scalars.shape[1]
        ks = [k % (1 << bits) for k in words_to_ints(
            scalars.cpu().numpy().view("uint32"))]
        adds = sum(bin(k).count("1") for k in ks)
        dbls = sum(max(k.bit_length() - 1, 0) for k in ks)
        return record("scalar_mult" + group.ctx.tag, K_SMULT,
                      K.scalar_mult_plain, (table, scalars, bits, group),
                      adds * w["add_canon"] + dbls * w["dbl_canon"],
                      n * (w["aff"] + 32 + w["pt"]))

    # the tree sum: N - 1 canonical adds; every lane read once, one point
    # written
    tsum = lanes(K.tree_sum, K.tree_sum_plain, "tree_sum", 1,
                 lambda n, w, *a: (n - 1) * w["add_canon"],
                 lambda n, w, *a: (n + 1) * w["pt"])

    def rsum(m, g, walk, steps, group=G1):
        # two canonical adds a step a lane; m, g and every step's addends
        # read once, m and g written once; the plain form (steps one-step
        # plain forms) replayed from a CUDA graph
        w, n = WORK[group.ctx.tag], m.shape[1]
        return record("running_sum" + group.ctx.tag, K_RSUM, RSUM_PLAIN,
                      (m, g, walk, steps, group),
                      2 * steps * n * w["add_canon"],
                      (steps + 4) * n * w["pt"])

    K_MMC, K_PREP, K_TREE = K.mont_mul_const, K.point_prep, T.run_tree_level
    MMC_PLAIN = graphed(K.mont_mul_const_plain)
    PREP_PLAIN = graphed(K.point_prep_plain)
    K_FINISH, K_STAGE1 = T.packed_finish, K.bpr_stage1
    K_STAGE2, K_BFOLD = K.bpr_stage2, K.bpr_fold
    replays += [MMC_PLAIN, PREP_PLAIN]
    K_STREAM, K_FUSED = S.accumulate_buckets_streamed, SK.fused_segments
    K_FOLD = SK.fold_pieces
    K_LEGACY, K_SMULT = buckets.legacy_buckets, K.scalar_mult
    K_RSUM, RSUM_PLAIN = K.running_sum, graphed(K.running_sum_plain)
    replays.append(RSUM_PLAIN)
    patches = [
        (cuzk, "mont_mul_const", mmc), (naive, "mont_mul_const", mmc),
        (cuzk, "point_prep", prep), (naive, "point_prep", prep),
        (K, "point_prep", prep),
        (T, "run_tree_level", tree), (T, "packed_finish", finish),
        (cuzk, "accumulate_buckets_streamed", stream),
        (SK, "fused_segments", fusedk), (SK, "fold_pieces", foldk),
        (bpr, "bpr_stage1", stage1), (bpr, "bpr_stage2", stage2),
        (bpr, "bpr_fold", fold),
        (cuzk, "legacy_buckets", legacyk), (cuzk, "fold_pieces", foldk),
        (naive, "tree_sum", tsum), (naive, "scalar_mult", smult),
        (K, "running_sum", rsum), (K, "bpr_stage1", stage1),
    ]
    runs = (("tree", run_msm, inputs[20]), ("stream", run_msm, inputs[17]),
            ("legacy", pippenger_msm, inputs[16]),
            ("naive", naive_msm, inputs[16]),
            ("running_sum", running_sum_chain, inputs[16][:1]),
            ("fused_10", run_msm, inputs[10]),
            ("fused", run_msm, inputs[14]),
            ("fused_forced",
             engine_msm(smvp_mode="fused", chunk_size=FORCED_CHUNK), inputs[16]),
            ("pure_tree", engine_msm(smvp_mode="tree"), inputs[18]),
            ("ed_tree", run_ed_msm, ed_inputs[20]),
            ("ed_stream", run_ed_msm, ed_inputs[17]),
            ("ed_legacy", pippenger_msm, (*ed_inputs[16], ED)),
            ("ed_naive", naive_msm, (*ed_inputs[16], ED)),
            ("ed_running_sum", running_sum_chain, (ed_inputs[16][0], ED)),
            ("ed_fused_10", run_ed_msm, ed_inputs[10]),
            ("ed_fused", run_ed_msm, ed_inputs[14]))
    for path, fn, args in runs:
        current = stats[path] = {}
        with patched(patches):
            fn(*args)
        # a path's graphs (and the memory they hold) end with it
        for plain in replays:
            plain.graphs.clear()
    return stats


@contextlib.contextmanager
def patched(patches):
    """Replace module attributes for the duration of the block."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


#: the engine's stages, as msm_device and compute_msm call them on the
#: tree, stream and fused paths (a path reports the stages it ran)
STAGES = ("words_to_device", "point_prep", "decompose_scalars_signed",
          "build_bucket_plan", "build_hybrid_plan", "tree_smvp_hybrid", "build_stream_layout",
          "accumulate_buckets_streamed", "make_wide_rows", "pregather_signed",
          "accumulate_buckets_fused", "accumulate_buckets_windowed",
          "bpr_order_on", "permute_buckets", "reduce_buckets_prearranged",
          "mont_mul_const", "_finalize")


def stage_breakdown(pw, sw, run=run_msm):
    """Phase 5: one MSM (compute_msm, or `run`), after a warm-up call, with
    every engine stage fenced by torch.cuda.synchronize() and timed on the
    host clock.  "other" is the rest of the call: wire-format checks,
    chunk choice, and the transpose of point-major scalar words on the
    card."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.models import cuzk

    secs = dict.fromkeys(STAGES, 0.0)

    def fence(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            return out
        return run

    eng = cuzk.CuzkMsmEngine
    # phase 4's plain forms leave the allocators' caches in pieces: the
    # first call after them pays for that, so one call goes unmeasured
    run(pw, sw)
    with patched([(cuzk, s, fence(s, getattr(cuzk, s))) for s in STAGES[:-1]]
                 + [(eng, "_finalize", fence("_finalize", eng._finalize))]):
        _, total = run(pw, sw)
    secs = {k: v for k, v in secs.items() if v}
    secs["other"] = total - sum(secs.values())
    return secs, total


def batch_breakdown(pw, sws):
    """Phase 5 for the batch: one warm compute_msm_batch with its three
    stages fenced (shared point prep; every set's plan, SMVP, BPR and
    exit; the one readback and the host Horner).  "other" is the wire
    checks of the sets."""
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine as eng

    secs = {}

    def fence(name):
        fn = getattr(eng, name)

        def run(*args):
            out, secs[name] = fenced(fn, *args)
            return out
        return run

    names = ("_batch_prep", "_batch_sets", "_batch_finish")
    with patched([(eng, name, fence(name)) for name in names]):
        _, total = fenced(eng().compute_msm_batch, pw, sws)
    secs["other"] = total - sum(secs.values())
    return secs, total


def copy_breakdown(label, words):
    """Phase 5: the engine's copy of host words to the card (pinned
    chunks, filled by host threads, each copy enqueued as its chunk is
    filled) beside one plain .to(device) of the same words made
    contiguous (pageable, blocking) and beside the unchunked staging of
    earlier versions in its three parts: the pinned buffer from PyTorch's
    caching host allocator, the host fill (np.copyto) and the device copy
    of the whole buffer; alternating, fenced, host clock; all must give
    the same tensor."""
    import numpy as np
    import torch

    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import words_to_device

    dev = torch.device(DEV)

    def plain(w):
        return torch.from_numpy(np.ascontiguousarray(w).view(np.int32)).to(dev)

    def unchunked(w):
        host = w.view(np.int32)
        t0 = time.perf_counter()
        staged = torch.empty(host.shape, dtype=torch.int32, pin_memory=True)
        t1 = time.perf_counter()
        np.copyto(staged.numpy(), host)
        t2 = time.perf_counter()
        out = staged.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for part, dt in (("pinned buffer", t1 - t0), ("host fill", t2 - t1),
                         ("device copy", t3 - t2)):
            ms[f"unchunked {part}"].append(round(dt * 1e3, 2))
        return out

    ms = {k: [] for k in ("words_to_device", "plain .to(device)",
                          "unchunked total", "unchunked pinned buffer",
                          "unchunked host fill", "unchunked device copy")}
    for _ in range(3):
        got, dt = fenced(words_to_device, words, dev)
        ms["words_to_device"].append(round(dt * 1e3, 2))
        want, dt = fenced(plain, words)
        ms["plain .to(device)"].append(round(dt * 1e3, 2))
        again, dt = fenced(unchunked, words)
        ms["unchunked total"].append(round(dt * 1e3, 2))
        if not (torch.equal(got, want) and torch.equal(again, want)):
            raise SystemExit(f"{label}: the copies differ")
    log(f"  {label} {words.shape} {words.nbytes / 1e6:.1f} MB, C-contiguous "
        f"{words.flags['C_CONTIGUOUS']}: " + "; ".join(
            f"{k} {statistics.median(v):.2f} ms {v}" for k, v in ms.items()))


def device_busy_share(fn, args):
    """--profile: torch.profiler over one warm run of fn; returns (wall s,
    device-busy s summed over kernels and copies, top ops by device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, total = fenced(fn, *args)
    # device-side events only (kernels, copies): a host op also carries the
    # time of the kernels it launched, which would count them twice
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if not busy:
        raise SystemExit("profile: the profiler saw no device time")
    return total, busy, [(e.key, e.self_device_time_total / 1e3, e.count)
                         for e in events[:10]]


def main(argv: list[str]) -> int:
    profile = "--profile" in argv
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from webgpu_msm_bls12_377_tpu_torch.ops import kernels  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 1
    with open(os.path.join(ROOT, "test-data", "goldens.json")) as f:
        goldens = json.load(f)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # the engines' tuning table (harness/autotune.py): an empty one for
        # the whole script, never the repo's; the autotune step writes a
        # second one, which nothing else reads
        for d in ("empty", "tuned"):
            os.mkdir(os.path.join(tmp, d))
        os.environ["MSM_AUTOTUNE_DIR"] = os.path.join(tmp, "empty")
        return phases(goldens, profile, os.path.join(tmp, "tuned"))


def phases(goldens, profile: bool, tuned_dir: str) -> int:
    """Phases 1-5 and the three last lines; exits nonzero at a failure."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from webgpu_msm_bls12_377_tpu_torch.harness import microbench
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase("phase 1", "the kernels' build")
    t0 = time.perf_counter()
    out_dir, build_s = K.build_all()
    log(f"phase 1: kernels built in {build_s:.1f} s "
        f"({time.perf_counter() - t0:.1f} s with checks) into {out_dir}")
    # the product study's C-form build of tree.cu (both fields), compiled
    # while phases 2 and 3 run
    pool = ThreadPoolExecutor(1)
    variant_build = pool.submit(microbench._form_libs, "c_form")
    pool.shutdown(wait=False)
    for name, source, _ in K.LIBRARIES:
        for line in (out_dir / f"{name}.log").read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  {source}.cu ({name}): {line.strip()}")

    phase("phase 2", "kernels against their plain forms (bit-exact)")
    check_kernels_random()

    phase("phase 3", "every path against the pinned goldens")
    counts, inputs, sets, medians = main_paths(goldens)
    ed_inputs, _ = edwards_paths(goldens, counts, medians)
    phase("phase 3 harness", "the harness (zipf cases, debug_check, "
          "bench_torch.py)")
    harness_runs(inputs, ed_inputs, medians)
    phase("phase 3 harness 2", "the harness, part 2 (autotune, the sweep, "
          "the microbench and its product study)")
    rates = harness2_runs(goldens, inputs, ed_inputs, tuned_dir,
                          variant_build)

    phase("phase 4", "per-kernel time at each path's "
          "shapes (2^20 tree, 2^17 stream, 2^16 legacy, naive and chain, "
          "2^10 and 2^14 default fused, 2^16 forced fused (chunk "
          f"{FORCED_CHUNK}), 2^18 pure tree; Edwards "
          "2^20 tree, 2^17 stream, 2^16 legacy, naive and chain, 2^10 and "
          "2^14 fused)")
    stats = timed_paths(inputs, ed_inputs)
    rows = []
    for path, per_kernel in stats.items():
        for name in PATHS[path]:
            s = per_kernel[name]
            if s["err"]:
                raise SystemExit(f"{name}: kernel and plain differ ({path})")
            t_mul = s["muls"] / PEAK_MULS * 1e3
            t_mem = s["bytes"] / PEAK_BYTES * 1e3
            t_int = s["muls"] / rates["_ed" if name.endswith("_ed") else ""] * 1e3
            row = {
                "name": name, "route": "cuda", "source": KERNELS[name][0],
                "replaces": KERNELS[name][1], "path": path,
                "launches": counts[path].get(name, 0), "max_abs_err": s["err"],
                "ms": s["ms"], "plain_ms": s["plain_ms"],
                "bound_ms": max(t_mul, t_mem),
                "bound_by": "operations" if t_mul >= t_mem else "bytes",
                "library_ms": None,
                # the same bound at the measured integer word-product rate
                "int_bound_ms": max(t_int, t_mem),
                "int_bound_by": "operations" if t_int >= t_mem else "bytes",
            }
            if HOME[name] == path:
                rows.append(row)
            log(f"  {path:12s} {name:25s} launches {row['launches']:3d}  "
                f"kernel {s['ms']:10.3f} ms  plain {s['plain_ms']:10.1f} ms  "
                f"bound {row['bound_ms']:8.3f} ms ({row['bound_by']}), at the "
                f"integer rate {row['int_bound_ms']:8.3f} ms "
                f"({row['int_bound_by']})")
    if {r["name"] for r in rows} != set(KERNELS):
        raise SystemExit("a kernel has no timed row")

    for label, run, (pw, sw) in [
            *((f"2^{p}", run_msm, inputs[p]) for p in (20, 17, 16, 14)),
            ("2^20 from wire bytes", run_msm, to_wire(*inputs[20])),
            *((f"Edwards 2^{p}", run_ed_msm, ed_inputs[p]) for p in (20, 14)),
            ("Edwards 2^20 from wire bytes", run_ed_msm,
             to_wire(*ed_inputs[20]))]:
        phase("phase 5", f"stage breakdown of one warm {label} MSM (each "
              "stage fenced)")
        secs, total = stage_breakdown(pw, sw, run)
        for name, s in sorted(secs.items(), key=lambda kv: -kv[1]):
            log(f"  {name:28s} {s * 1e3:9.2f} ms  {100 * s / total:5.1f} %")
        log(f"  total (fenced)               {total * 1e3:9.2f} ms")
    log(f"phase 5: one warm 2^20 batch of {BATCH_SETS} sets, its stages fenced")
    secs, total = batch_breakdown(inputs[20][0], sets[20])
    for name, sec in secs.items():
        log(f"  {name:28s} {sec * 1e3:9.2f} ms  {100 * sec / total:5.1f} %")
    log(f"  total (fenced)               {total * 1e3:9.2f} ms: "
        f"{total / BATCH_SETS:.4f} s per set ({secs['_batch_sets'] / BATCH_SETS:.4f}"
        f" s of it per-set stages) beside {medians['tree']:.4f} s, the warm "
        "median of one 2^20 compute_msm")
    log("phase 5: host-to-device copies of the 2^20 case")
    import numpy as np

    wire_pw, wire_sw = (np.frombuffer(b, dtype="<u4").reshape(1 << 20, -1)
                        for b in to_wire(*inputs[20]))
    copy_breakdown("points (word-major)", inputs[20][0])
    copy_breakdown("points (wire bytes, point-major)", wire_pw)
    copy_breakdown("scalars (word-major)", inputs[20][1])
    copy_breakdown("scalars (wire bytes, point-major)", wire_sw)
    if profile:
        from webgpu_msm_bls12_377_tpu_torch import (
            compute_msm,
            compute_msm_edwards,
        )

        for label, fn, args in (("2^20 tree", compute_msm, inputs[20]),
                                ("Edwards 2^20 tree", compute_msm_edwards,
                                 ed_inputs[20]),
                                ("2^17 stream", compute_msm, inputs[17]),
                                ("2^14 fused", compute_msm, inputs[14]),
                                ("Edwards 2^14 fused", compute_msm_edwards,
                                 ed_inputs[14]),
                                (f"2^20 batch of {BATCH_SETS}", batch_msm,
                                 (inputs[20][0], sets[20])),
                                ("2^16 legacy", pippenger_msm, inputs[16]),
                                ("2^16 naive", naive_msm, inputs[16]),
                                ("Edwards 2^16 legacy", pippenger_msm,
                                 (*ed_inputs[16], ED)),
                                ("Edwards 2^16 naive", naive_msm,
                                 (*ed_inputs[16], ED))):
            wall, busy, top = device_busy_share(fn, args)
            log(f"profile {label}: wall {wall * 1e3:.2f} ms, device busy "
                f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f} %), idle "
                f"{100 * (1 - busy / wall):.1f} %")
            for key, ms, count in top:
                log(f"  {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    log(f"all phases passed in {elapsed():.1f} s; seconds by phase: "
        f"{phase_seconds()}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
