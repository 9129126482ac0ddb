#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which fails the run on any error:
  1. the card's name and power limit (nvidia-smi), and the build of every
     kernel source under webgpu_msm_bls12_377_tpu_torch/csrc/ with nvcc;
  2. every kernel entry point against its plain PyTorch form on random
     inputs of a few thousand lanes (and a small real plan for the tree,
     finish, stream and fused kernels): bit-exact equality;
  3. every path through the entry points a user calls, on the
     distinct-point bench cases held against the pinned goldens in
     test-data/goldens.json: compute_msm with default options at 2^10 and
     2^14 (fused path, chunk 4), 2^16 and 2^17 (stream path, chunk 15),
     2^18 and 2^20 (hybrid tree, chunk 15 and 16); beside the 2^14 default,
     the same case forced through the legacy path (chunk 4) and the stream
     path (chunks 9 and 13); the fused path forced at 2^16 and chunk 15;
     the pure tree forced at 2^18;
     PippengerMsmEngine (legacy path) and NaiveMsmEngine at 2^16; a
     running-sum chain through the one kernel no engine calls, held
     against the bigint oracle; compute_msm_batch of 8 scalar sets at
     2^20 (tree) against the pinned batch goldens and of 4 sets at 2^17
     (stream) against compute_msm per set, each with PyTorch's sync debug
     mode raising on any wait for the device between sets.  Cold time,
     median of 3 warm runs, and each kernel's launches in one run (counts
     zeroed just before, read just after); every path must launch the
     kernels it names, and together the paths cover every kernel;
  4. one more run of each path (2^20 tree, 2^17 stream, 2^16 legacy, 2^16
     naive, the chain, 2^14 and forced 2^16 fused, 2^18 pure tree) in
     which every kernel launch is timed with CUDA events and repeated
     with its plain form on the same inputs, which must agree bit for
     bit: per-kernel time, plain time and the bound (least time for the
     same work on an H100 SXM).  The fused kernel's plain form runs one
     lockstep round per entry of the longest bucket, 8,188 at the 2^14
     default shape: here its round is replayed from a CUDA graph;
  5. one more 2^20, 2^17, 2^16 and 2^14 MSM with every engine stage fenced
     and timed, and one more 2^20 batch fenced as shared prep, per-set
     stages, and readback with Horner; the engine's host-to-device copy
     of the 2^20 words beside one plain .to(device); with --profile, also
     torch.profiler over one 2^20, 2^17, 2^14, Pippenger and naive run
     and one batch: the device's busy and idle share and the ops that
     take the most device time.
Then three lines: the per-kernel JSON record, the card's name and power
limit as nvidia-smi prints them, and last {"ok": true, "device": {...}}.
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
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

#: H100 SXM published peaks: HBM bytes/s, and 32-bit
#: multiply-adds/s taken as half the 67 TFLOP/s float32 rate (the card
#: publishes no integer rate; one 32x32->64 word product = one multiply-add)
PEAK_BYTES = 3.35e12
PEAK_MULS = 67e12 / 2
MM, MMP = 2 * 13 * 13, 3 * 13 * 13  # word products: Montgomery product, pair
ADD_AFF = 4 * MM + 3 * MMP  # add_affine_lazy_pair
ADD_FULL = 6 * MM + 3 * MMP  # add_lazy_pair
ADD_MIXED = 5 * MM + 3 * MMP  # add_mixed_lazy_pair
DBL = 8 * MM  # double_lazy, and the canonical double
ADD_CANON, ADD_MIXED_CANON = 12 * MM, 11 * MM  # canonical add, add_mixed
PT = 39 * 4  # bytes of one projective point
AFF = 26 * 4  # bytes of one affine point
BENCH = ((10, 4), (14, 4), (16, 15), (17, 15), (18, 15), (20, 16))  # (power, chunk)
ROW = 32 * 4  # bytes of one pre-gathered row of the fused path
BATCH_SETS, STREAM_BATCH_SETS = 8, 4
FORCED_CHUNK = 15  # the forced fused run: the Pippenger row's shapes at 2^16
FORCED_14 = (9, 13)  # stream chunks forced at 2^14, beside the default's 4
DEV = "cuda"

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "mont_mul_const": ("webgpu_msm_bls12_377_tpu_torch/csrc/convert.cu",
                       "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:238"),
    "tree_level_aff": ("webgpu_msm_bls12_377_tpu_torch/csrc/tree.cu",
                       "webgpu_msm_bls12_377_tpu/ops/smvp_tree.py:416"),
    "tree_level_full": ("webgpu_msm_bls12_377_tpu_torch/csrc/tree.cu",
                        "webgpu_msm_bls12_377_tpu/ops/smvp_tree.py:416"),
    "packed_finish": ("webgpu_msm_bls12_377_tpu_torch/csrc/packed.cu",
                      "webgpu_msm_bls12_377_tpu/ops/smvp_stream.py:475"),
    "bpr_running_add": ("webgpu_msm_bls12_377_tpu_torch/csrc/bpr.cu",
                        "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:451"),
    "bpr_double": ("webgpu_msm_bls12_377_tpu_torch/csrc/bpr.cu",
                   "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:383"),
    "bpr_masked_add_double": ("webgpu_msm_bls12_377_tpu_torch/csrc/bpr.cu",
                              "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:468"),
    "bpr_add": ("webgpu_msm_bls12_377_tpu_torch/csrc/bpr.cu",
                "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:435"),
    "stream_buckets": ("webgpu_msm_bls12_377_tpu_torch/csrc/stream.cu",
                       "webgpu_msm_bls12_377_tpu/ops/smvp_stream.py:541"),
    "masked_add_mixed": ("webgpu_msm_bls12_377_tpu_torch/csrc/legacy.cu",
                         "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:272"),
    "fused_add": ("webgpu_msm_bls12_377_tpu_torch/csrc/canon.cu",
                  "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:302"),
    "masked_add_and_double": ("webgpu_msm_bls12_377_tpu_torch/csrc/canon.cu",
                              "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:488"),
    "fused_running_add": ("webgpu_msm_bls12_377_tpu_torch/csrc/canon.cu",
                          "webgpu_msm_bls12_377_tpu/ops/pallas_kernels.py:415"),
    "fused_buckets": ("webgpu_msm_bls12_377_tpu_torch/csrc/fused.cu",
                      "webgpu_msm_bls12_377_tpu/ops/smvp_kernel.py:223"),
}

BPR = ("bpr_running_add", "bpr_double", "bpr_masked_add_double", "bpr_add")
#: the kernels each path must launch; a kernel's row in the JSON record
#: (launches, times, bound) comes from the first path that names it
PATHS = {
    "tree": ("mont_mul_const", "tree_level_aff", "tree_level_full",
             "packed_finish", *BPR),
    "stream": ("stream_buckets", "mont_mul_const", *BPR),
    "legacy": ("masked_add_mixed", "mont_mul_const", *BPR),
    "naive": ("masked_add_and_double", "fused_add", "mont_mul_const"),
    # no engine of either package calls fused_running_add: the chain
    # drives it, beside the lazy running add it must agree with mod p
    "running_sum": ("fused_running_add", "bpr_running_add"),
    # default options at 2^14 and 2^10: chunk 4 has 8 buckets a window,
    # one per BPR lane, so BPR runs no running add and no pre-double
    "fused": ("fused_buckets", "mont_mul_const", "bpr_masked_add_double",
              "bpr_add"),
    "fused_10": ("fused_buckets", "mont_mul_const", "bpr_masked_add_double",
                 "bpr_add"),
    # the 2^14 case forced off its default path, for the times alone
    "legacy_14": ("masked_add_mixed", "mont_mul_const",
                  "bpr_masked_add_double", "bpr_add"),
    "stream_14": ("stream_buckets", "mont_mul_const"),
    "fused_forced": ("fused_buckets", "mont_mul_const", *BPR),
    "pure_tree": ("tree_level_aff", "tree_level_full", "mont_mul_const", *BPR),
}
PATHS["batch_tree"], PATHS["batch_stream"] = PATHS["tree"], PATHS["stream"]
HOME = {k: path for path in reversed(PATHS) for k in PATHS[path]}


def log(*a):
    print(*a, flush=True)


def max_abs_err(a, b) -> int:
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def rand_plane(rng, rows, n, bound):
    """(rows, n) plane of random values < bound (a multiple of p)."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import field as F

    planes = [F.ints_to_plane([rng.randrange(bound) for _ in range(n)])
              for _ in range(rows // 13)]
    return torch.cat(planes).to(DEV)


def check_kernels_random() -> None:
    """Phase 2: every entry point against its plain form, bit-exact."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_tree as T
    from webgpu_msm_bls12_377_tpu_torch.ops.buckets import build_bucket_plan
    from webgpu_msm_bls12_377_tpu_torch.ops.decompose import (
        decompose_scalars_signed,
    )
    from webgpu_msm_bls12_377_tpu_torch.ops.field import P
    from webgpu_msm_bls12_377_tpu_torch.params import BLS12_377_PARAMS

    rng = random.Random("chip-smoke-kernels")
    n = 4096
    cases = []
    a = rand_plane(rng, 26, n, P)
    for y in (BLS12_377_PARAMS.r2, 1):
        cases.append(("mont_mul_const", K.mont_mul_const(a, y),
                      K.mont_mul_const_plain(a, y)))
    m, g, b = (rand_plane(rng, 39, n, 2 * P) for _ in range(3))
    bits = torch.randint(0, 2, (n,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1)).to(DEV)
    pairs = [
        ("bpr_running_add", K.bpr_running_add(m, g, b),
         K.running_add_plain(m, g, b)),
        ("bpr_double", K.bpr_double(m), K.double_plain(m)),
        ("bpr_masked_add_double", K.bpr_masked_add_double(m, g, bits),
         K.masked_add_double_plain(m, g, bits)),
        ("bpr_add", K.bpr_add(m, b), K.add_plain(m, b)),
    ]
    for name, got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for x, y in zip(got, want):
            cases.append((name, x, y))
    # a small real plan: 2048 points, chunk 8, K = 2
    npts, chunk, windows = 2048, 8, 32
    table = S.build_signed_table(rand_plane(rng, 26, npts, P))
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
            "tree_level_aff",
            T.run_tree_level(table, hp.level_map1, "aff", last, plan.sorted_vals),
            T.tree_level_plain(table, hp.level_map1, "aff", last,
                               plan.sorted_vals),
        ))
    lvl1 = T.run_tree_level(table, hp.level_map1, "aff",
                            sorted_vals=plan.sorted_vals)
    c1, s1 = T.chain_counts(hp.lens, 1)
    c2, s2 = T.chain_counts(hp.lens, 2)
    (_, cap2) = T.level_caps(kn, hp.lens.shape[0], 2)
    map2 = T.build_level_map(s1, c1, s2, c2, cap2)
    for last in (False, True):
        cases.append(("tree_level_full", T.run_tree_level(lvl1, map2, "full", last),
                      T.tree_level_plain(lvl1, map2, "full", last)))
    lvl2 = T.run_tree_level(lvl1, map2, "full")
    cases.append(("packed_finish", S.packed_finish(lvl2, hp.layout),
                  S.packed_finish_plain(lvl2, hp.layout.starts_rk,
                                        hp.layout.lens_rk)))
    layout = S.build_stream_layout(plan.starts, plan.lens, windows)
    cases.append((
        "stream_buckets",
        S.accumulate_buckets_streamed(table, plan.sorted_vals, layout),
        S.accumulate_buckets_streamed_plain(table, plan.sorted_vals,
                                            layout.starts_rk, layout.lens_rk),
    ))
    # fused segment SMVP: the same plan (empty, short and long buckets),
    # in one launch and window by window, then hand-made segments over
    # random rows: empty, length 1, long, overlapping
    wide = SK.make_wide_rows(table[:, :npts].contiguous())
    gathered = SK.pregather_signed(wide, plan.sorted_vals)
    if int(plan.lens.min()) != 0 or int(plan.lens.max()) <= 64:
        raise SystemExit("the fused plan lacks an empty or a long bucket")
    want = SK.accumulate_buckets_fused_plain(gathered, plan.starts, plan.lens)
    cases.append(("fused_buckets", SK.accumulate_buckets_fused(
        gathered, plan.starts, plan.lens), want))
    cases.append(("fused_buckets", SK.accumulate_buckets_windowed(
        wide, plan.sorted_vals, plan.starts, plan.lens, windows), want))
    rrows = torch.zeros((600, SK.ROW_WORDS), dtype=torch.int32, device=DEV)
    rrows[:, :26] = rand_plane(rng, 26, 600, P).T
    rlens = [0, 1, 2, 65, 0, 33, 1, 100] + [rng.randrange(9) for _ in range(992)]
    rstarts = [rng.randrange(600 - l + 1) for l in rlens]
    rstarts, rlens = (torch.tensor(v, dtype=torch.int32, device=DEV)
                      for v in (rstarts, rlens))
    cases.append(("fused_buckets",
                  SK.accumulate_buckets_fused(rrows, rstarts, rlens),
                  SK.accumulate_buckets_fused_plain(rrows, rstarts, rlens)))
    # the plain form as phase 4 runs it (its round replayed from a CUDA
    # graph) against the plain form run eagerly
    cases.append(("fused_buckets",
                  fused_plain_graphed(gathered, plan.starts, plan.lens), want))
    # canonical kernels: operands below p
    ca, cg, cb = (rand_plane(rng, 39, n, P) for _ in range(3))
    aff = rand_plane(rng, 26, n, P)
    valid = torch.randint(0, 2, (n,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(2)).to(DEV)
    pairs = [
        ("masked_add_mixed", K.masked_add_mixed(ca, aff, bits, valid),
         K.masked_add_mixed_plain(ca, aff, bits, valid)),
        ("fused_add", K.fused_add(ca, cb), K.fused_add_plain(ca, cb)),
        ("masked_add_and_double", K.masked_add_and_double(ca, cg, bits),
         K.masked_add_and_double_plain(ca, cg, bits)),
        ("fused_running_add", K.fused_running_add(ca, cg, cb),
         K.fused_running_add_plain(ca, cg, cb)),
    ]
    for name, got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for x, y in zip(got, want):
            cases.append((name, x, y))
    torch.cuda.synchronize()
    bad = []
    for name, got, want in cases:
        err = max_abs_err(got, want)
        log(f"  kernel {name:24s} {tuple(got.shape)} vs plain: "
            f"max_abs_err {err}")
        if err:
            bad.append(name)
    seen = {c[0] for c in cases}
    if bad or seen != set(KERNELS):
        raise SystemExit(f"kernel mismatch: {bad}, untested: {set(KERNELS) - seen}")


def fused_plain_graphed(gathered, starts, lens):
    """accumulate_buckets_fused_plain with its round (smvp_kernel.fused_round,
    ~5,000 small PyTorch ops) captured once in a CUDA graph and replayed
    once per entry of the longest bucket: the same plain ops on the same
    operands in the same order, without the host's cost per op, which at
    the 8,188 rounds of the 2^14 default shape is 12 minutes."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK

    starts, lens = starts.to(torch.int64), lens.to(torch.int64)
    rounds = int(lens.max()) if lens.numel() else 0
    acc = [c.clone() for c in SK.G1.zero(starts.shape[0], gathered.device)]
    t = torch.zeros((), dtype=torch.int64, device=gathered.device)
    if not rounds:
        return C.merge(acc)

    def step():
        new = SK.fused_round(C.ProjG1(*acc), gathered, starts, lens, t)
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
    for a, z in zip(acc, SK.G1.zero(starts.shape[0], gathered.device)):
        a.copy_(z)
    t.zero_()
    for _ in range(rounds):
        graph.replay()
    return C.merge(acc)


def bench_case(power: int):
    """The port's copy of the bench case seed scheme
    (harness/testdata.py:make_bench_case): ks and scalars from
    random.Random(f"bench-{power}-bls12_377"), points k_i * G computed
    on the card with kernel 4's double-and-add, one host batch inversion."""
    import numpy as np
    import torch

    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import field as F
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops.convert import ints_to_words
    from webgpu_msm_bls12_377_tpu_torch.params import (
        BLS12_377_G1_GENERATOR_X as GX,
        BLS12_377_G1_GENERATOR_Y as GY,
        BLS12_377_PARAMS as MP,
        SCALAR_FIELD,
    )

    n = 1 << power
    rng = random.Random(f"bench-{power}-bls12_377")
    ks = [rng.randrange(1, SCALAR_FIELD) for _ in range(n)]
    scalars = [rng.randrange(0, 1 << 253) for _ in range(n)]
    kw = torch.from_numpy(ints_to_words(ks, 8).astype(np.int64)).to(DEV)
    g1 = C.G1Ops()
    gen = F.ints_to_plane([MP.to_mont(GX), MP.to_mont(GY)]).to(DEV)
    temp = C.merge(g1.from_affine((gen[:, :1].expand(13, n),
                                   gen[:, 1:].expand(13, n))))
    res = C.merge(g1.zero(n, DEV))
    for bit in range(253):
        bits = ((kw[bit // 32] >> (bit % 32)) & 1).to(torch.int32)
        res, temp = K.bpr_masked_add_double(res, temp, bits)
    proj = K.mont_mul_const(C.merge(g1.canon(C.split(res))), 1)
    xs, ys, zs = (F.plane_to_ints(proj[c * 13:(c + 1) * 13]) for c in range(3))
    pts = batch_to_affine(F.P, xs, ys, zs)
    point_words = np.stack([ints_to_words([p[0] for p in pts], 12),
                            ints_to_words([p[1] for p in pts], 12)])
    return point_words, ints_to_words(scalars, 8)


def batch_scalars(power: int, num_sets: int):
    """The port's copy of the batch case seed scheme
    (harness/testdata.py:make_batch_case): num_sets scalar sets over the
    bench case's points, drawn in order from
    random.Random(f"bench-{power}-bls12_377-batch")."""
    from webgpu_msm_bls12_377_tpu_torch.ops.convert import ints_to_words

    rng = random.Random(f"bench-{power}-bls12_377-batch")
    return [ints_to_words([rng.randrange(0, 1 << 253)
                           for _ in range(1 << power)], 8)
            for _ in range(num_sets)]


def batch_to_affine(p, xs, ys, zs):
    """Projective -> affine with one modular inversion (Montgomery's trick)."""
    n = len(zs)
    prefix = [1] * (n + 1)
    for i, z in enumerate(zs):
        if z % p == 0:
            raise ValueError("point at infinity")
        prefix[i + 1] = prefix[i] * z % p
    inv = pow(prefix[n], p - 2, p)
    out = [None] * n
    for i in range(n - 1, -1, -1):
        zi = prefix[i] * inv % p
        inv = inv * zs[i] % p
        out[i] = (xs[i] * zi % p, ys[i] * zi % p)
    return out


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


def engine_msm(**opts):
    """compute_msm of a CuzkMsmEngine with the given options."""
    def run(pw, sw):
        from webgpu_msm_bls12_377_tpu_torch.models import CuzkMsmEngine

        return CuzkMsmEngine(**opts).compute_msm(pw, sw)
    return run


def batch_msm(pw, sws):
    """compute_msm_batch with default options; the per-set stage runs with
    PyTorch's sync debug mode raising on any call that waits for the
    device."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.models import CuzkMsmEngine

    real = CuzkMsmEngine._batch_sets

    def strict(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    with patched([(CuzkMsmEngine, "_batch_sets", strict)]):
        return CuzkMsmEngine().compute_msm_batch(pw, sws)


def pippenger_msm(pw, sw):
    from webgpu_msm_bls12_377_tpu_torch.models import PippengerMsmEngine

    return PippengerMsmEngine().compute_msm(pw, sw)


def naive_msm(pw, sw):
    """NaiveMsmEngine's device function, then the affine result."""
    from webgpu_msm_bls12_377_tpu_torch.models import NaiveMsmEngine
    from webgpu_msm_bls12_377_tpu_torch.ops import field as F
    from webgpu_msm_bls12_377_tpu_torch.reference import curve as ocurve

    out = NaiveMsmEngine().build_fn()(pw, sw)
    x, y = ocurve.g1_to_affine(ocurve.ProjectivePoint(
        *(F.plane_to_ints(out[c * 13:(c + 1) * 13])[0] for c in range(3))))
    return {"x": x, "y": y}


def running_sum_chain(pw, steps=8):
    """`steps` canonical running-sum steps (fused_running_add) over all
    points of a case, from the identity, with b_t the table rolled by t
    lanes; the lazy running add on the same operands must give the same
    canonical coordinates.  Returns lane 0 of g as the affine {"x", "y"}."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import (
        mont_point_table,
        words_to_device,
    )
    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import field as F
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.reference import curve as ocurve

    g1 = C.G1Ops()
    table = mont_point_table(words_to_device(pw, torch.device(DEV)))
    pts = C.merge(g1.from_affine((table[:13], table[13:])))
    m = g = lm = lg = C.merge(g1.zero(pts.shape[1], DEV))
    for t in range(steps):
        b = torch.roll(pts, t, dims=1).contiguous()
        m, g = K.fused_running_add(m, g, b)
        lm, lg = K.bpr_running_add(lm, lg, b)
    lazy = C.merge(g1.canon(C.split(lg)))
    if not torch.equal(g, lazy):
        raise SystemExit("running-sum chain: canonical and lazy forms differ")
    # Montgomery coordinates are the plain ones scaled by R: the same
    # projective point
    x, y = ocurve.g1_to_affine(ocurve.ProjectivePoint(
        *(F.plane_to_ints(g[c * 13:(c + 1) * 13, :1])[0] for c in range(3))))
    return {"x": x, "y": y}


def running_sum_oracle(pw, steps=8):
    """Lane 0 of running_sum_chain with Python integers: step t adds point
    (-t mod n) to m and m to g, so g = sum_t (steps - t) * P[-t]."""
    from webgpu_msm_bls12_377_tpu_torch.reference import curve as ocurve

    def point(i):
        return ocurve.g1_from_affine(*(
            sum(int(w) << (32 * j) for j, w in enumerate(pw[c, :, i]))
            for c in range(2)))

    g = ocurve.G1_ZERO
    for t in range(steps):
        g = ocurve.g1_add(g, ocurve.g1_scalar_mult(point(-t), steps - t))
    x, y = ocurve.g1_to_affine(g)
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
    n = args[0].shape[-1] * (len(want) if isinstance(want, list) else 1)
    log(f"  {label}: result OK; cold {cold:.3f} s, warm median {med:.4f} s "
        f"({[round(w, 4) for w in warm]}), {n / med:,.0f} points/s")
    log(f"  {label} launches per run: {launches}")
    missing = set(PATHS[path]) - {k for k, v in launches.items() if v}
    if missing:
        raise SystemExit(f"{label}: kernels not launched: {missing}")
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
        pw, sw = inputs[power] = bench_case(power)
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
        if power == 14:
            # what the default policy passes over at this size: ~12,000
            # lockstep rounds of kernel 6 (one warm run), and kernel 5
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
    # batches over a fixed point set: the point table converted once
    # (kernel 1 launches = 1 + one Montgomery exit per set)
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
        if counts[path]["mont_mul_const"] != 1 + num:
            raise SystemExit(f"{path}: kernel 1 ran "
                             f"{counts[path]['mont_mul_const']} times, not once "
                             f"for the points and once per set")
    log(f"  2^20 batch: {medians['batch_tree'] / BATCH_SETS:.4f} s per set "
        f"(warm median of the batch / {BATCH_SETS}) beside "
        f"{medians['tree']:.4f} s for one warm compute_msm")
    log(f"  2^17 batch: {medians['batch_stream'] / STREAM_BATCH_SETS:.4f} s "
        f"per set beside {medians['stream']:.4f} s for one warm compute_msm")
    covered = {k for names in PATHS.values() for k in names}
    if covered != set(KERNELS):
        raise SystemExit(f"no path names {set(KERNELS) - covered}")
    return counts, inputs, sets, medians


def timed_paths(inputs):
    """Phase 4: each kernel launch of one run of every path timed,
    repeated with its plain form, compared, and its work counted.
    Returns stats[path][kernel]."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.models import cuzk, naive
    from webgpu_msm_bls12_377_tpu_torch.ops import bpr, buckets, convert
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_kernel as SK
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_tree as T

    stats = {}
    current = {}

    def timed(fn, *args):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn(*args)
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    def record(name, kern, plain, args, muls, nbytes):
        """Time kern(*args) and plain(*args) and compare them."""
        got, ms = timed(kern, *args)
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

    def mmc(a, y):
        n = a.numel() // 13
        return record("mont_mul_const", K_MMC, K.mont_mul_const_plain,
                      (a, y), n * MM, 2 * 52 * n)

    def tree(arr_in, level_map, mode, last=False, sorted_vals=None):
        m = level_map.to(torch.int64)
        invalid = (m & T.FLAG_INVALID) != 0
        single = ((m & T.FLAG_SINGLE) != 0) & ~invalid
        pairs = int((~invalid & ~single).sum())
        reads = 2 * pairs + int(single.sum())
        t = m.shape[0]
        if mode == "aff":
            muls, nbytes = pairs * ADD_AFF, reads * (4 + AFF) + t * (4 + PT)
        else:
            muls, nbytes = pairs * ADD_FULL, reads * PT + t * (4 + PT)
        return record(f"tree_level_{mode}", K_TREE, T.tree_level_plain,
                      (arr_in, level_map, mode, last, sorted_vals), muls, nbytes)

    def bucket_work(lens, add_muls, entry_bytes):
        # a bucket of c entries needs c - 1 adds (the kernel's first add,
        # into the identity, is not part of the function)
        entries, nb = int(lens.sum()), lens.numel()
        adds = int((lens.to(torch.int64) - 1).clamp(min=0).sum())
        return adds * add_muls, entries * entry_bytes + nb * (8 + PT)

    def finish(plane, layout):
        return record(
            "packed_finish", lambda p, s, l: K_FINISH(p, layout),
            S.packed_finish_plain, (plane, layout.starts_rk, layout.lens_rk),
            *bucket_work(layout.lens_rk, ADD_FULL, PT))

    def stream(table, sorted_vals, layout):
        return record(
            "stream_buckets", lambda t, v, s, l: K_STREAM(t, v, layout),
            S.accumulate_buckets_streamed_plain,
            (table, sorted_vals, layout.starts_rk, layout.lens_rk),
            *bucket_work(layout.lens_rk, ADD_MIXED, 4 + AFF))

    def fusedk(gathered, starts, lens):
        # every entry is one canonical mixed add, the one into the identity
        # included: the function's result is that add chain's coordinates
        entries = int(lens.sum())
        log(f"  fused_buckets: {lens.numel()} buckets, {entries} entries, "
            f"the longest {int(lens.max())}")
        return record("fused_buckets", K_FUSED, fused_plain_graphed,
                      (gathered, starts, lens), entries * ADD_MIXED_CANON,
                      entries * ROW + lens.numel() * (8 + PT))

    def lanes(fn, plain, name, muls, nbytes):
        """Recorder for a lane-wise kernel: muls(n, *args), and nbytes per
        lane or, where the bytes depend on the data, nbytes(n, *args)."""
        def run(*args):
            n = args[0].shape[1]
            moved = nbytes(n, *args) if callable(nbytes) else nbytes * n
            return record(name, fn, plain, args, muls(n, *args), moved)
        return run

    running = lanes(K.bpr_running_add, K.running_add_plain, "bpr_running_add",
                    lambda n, *a: 2 * n * ADD_FULL, 5 * PT)
    double = lanes(K.bpr_double, K.double_plain, "bpr_double",
                   lambda n, *a: n * DBL, 2 * PT)
    masked = lanes(K.bpr_masked_add_double, K.masked_add_double_plain,
                   "bpr_masked_add_double",
                   lambda n, r, t, bits: int(bits.sum()) * ADD_FULL + n * DBL,
                   4 * PT + 4)
    add = lanes(K.bpr_add, K.add_plain, "bpr_add",
                lambda n, *a: n * ADD_FULL, 3 * PT)
    mixed = lanes(K.masked_add_mixed, K.masked_add_mixed_plain,
                  "masked_add_mixed",
                  lambda n, acc, aff, sign, valid:
                  int(valid.sum()) * ADD_MIXED_CANON,
                  # a masked lane's result is acc: it needs neither its
                  # addend nor its sign
                  lambda n, acc, aff, sign, valid:
                  n * (2 * PT + 4) + int(valid.sum()) * (AFF + 4))
    cadd = lanes(K.fused_add, K.fused_add_plain, "fused_add",
                 lambda n, *a: n * ADD_CANON, 3 * PT)
    cmasked = lanes(K.masked_add_and_double, K.masked_add_and_double_plain,
                    "masked_add_and_double",
                    lambda n, r, t, bits: int(bits.sum()) * ADD_CANON + n * DBL,
                    4 * PT + 4)
    crunning = lanes(K.fused_running_add, K.fused_running_add_plain,
                     "fused_running_add",
                     lambda n, *a: 2 * n * ADD_CANON, 5 * PT)

    K_MMC, K_TREE, K_FINISH = K.mont_mul_const, T.run_tree_level, T.packed_finish
    K_STREAM, K_FUSED = S.accumulate_buckets_streamed, SK.accumulate_buckets_fused
    patches = [
        (convert, "mont_mul_const", mmc), (cuzk, "mont_mul_const", mmc),
        (naive, "mont_mul_const", mmc),
        (T, "run_tree_level", tree), (T, "packed_finish", finish),
        (cuzk, "accumulate_buckets_streamed", stream),
        (cuzk, "accumulate_buckets_fused", fusedk),
        (SK, "accumulate_buckets_fused", fusedk),
        (bpr, "bpr_running_add", running), (bpr, "bpr_double", double),
        (bpr, "bpr_masked_add_double", masked), (bpr, "bpr_add", add),
        (buckets, "masked_add_mixed", mixed),
        (naive, "fused_add", cadd), (naive, "masked_add_and_double", cmasked),
        (K, "fused_running_add", crunning), (K, "bpr_running_add", running),
    ]
    runs = (("tree", run_msm, inputs[20]), ("stream", run_msm, inputs[17]),
            ("legacy", pippenger_msm, inputs[16]),
            ("naive", naive_msm, inputs[16]),
            ("running_sum", running_sum_chain, inputs[16][:1]),
            ("fused", run_msm, inputs[14]),
            ("fused_forced",
             engine_msm(smvp_mode="fused", chunk_size=FORCED_CHUNK), inputs[16]),
            ("pure_tree", engine_msm(smvp_mode="tree"), inputs[18]))
    for path, fn, args in runs:
        current = stats[path] = {}
        with patched(patches):
            fn(*args)
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
STAGES = ("words_to_device", "mont_point_table", "decompose_scalars_signed",
          "build_bucket_plan", "build_hybrid_plan", "build_signed_table",
          "tree_smvp_hybrid", "build_stream_layout",
          "accumulate_buckets_streamed", "make_wide_rows", "pregather_signed",
          "accumulate_buckets_fused", "accumulate_buckets_windowed",
          "bpr_order_on", "permute_buckets", "reduce_buckets_prearranged",
          "mont_mul_const", "_finalize")


def stage_breakdown(pw, sw):
    """Phase 5: one MSM, after a warm-up call, with every engine stage
    fenced by torch.cuda.synchronize() and timed on the host clock.
    "other" is the rest of the call: wire-format checks and chunk choice."""
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
    run_msm(pw, sw)
    with patched([(cuzk, s, fence(s, getattr(cuzk, s))) for s in STAGES[:-1]]
                 + [(eng, "_finalize", fence("_finalize", eng._finalize))]):
        _, total = run_msm(pw, sw)
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
    """Phase 5: the engine's copy of host words to the card (laid out
    straight into pinned memory, enqueued) beside one plain .to(device) of
    the same words made contiguous (pageable, blocking), alternating,
    fenced, host clock; the two must give the same tensor."""
    import numpy as np
    import torch

    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import words_to_device

    dev = torch.device(DEV)

    def plain(w):
        return torch.from_numpy(np.ascontiguousarray(w).view(np.int32)).to(dev)

    ms = {"words_to_device": [], "plain .to(device)": []}
    for _ in range(3):
        got, dt = fenced(words_to_device, words, dev)
        ms["words_to_device"].append(round(dt * 1e3, 2))
        want, dt = fenced(plain, words)
        ms["plain .to(device)"].append(round(dt * 1e3, 2))
        if not torch.equal(got, want):
            raise SystemExit(f"{label}: the two copies differ")
    log(f"  {label} {words.nbytes / 1e6:.1f} MB, C-contiguous "
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
        from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 1
    with open(os.path.join(ROOT, "test-data", "goldens.json")) as f:
        goldens = json.load(f)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    out_dir, build_s = K.build_all()
    log(f"phase 1: kernels built in {build_s:.1f} s "
        f"({time.perf_counter() - t0:.1f} s with checks) into {out_dir}")
    for name in K.SOURCES:
        for line in (out_dir / f"{name}.log").read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  {name}.cu: {line.strip()}")

    log("phase 2: kernels against their plain forms (bit-exact)")
    check_kernels_random()

    log("phase 3: every path against the pinned goldens")
    counts, inputs, sets, medians = main_paths(goldens)

    log("phase 4: per-kernel time at each path's shapes (2^20 tree, 2^17 "
        "stream, 2^16 legacy, naive and chain, 2^14 and forced 2^16 fused, "
        "2^18 pure tree)")
    stats = timed_paths(inputs)
    rows = []
    for path, per_kernel in stats.items():
        for name in PATHS[path]:
            s = per_kernel[name]
            if s["err"]:
                raise SystemExit(f"{name}: kernel and plain differ ({path})")
            t_mul = s["muls"] / PEAK_MULS * 1e3
            t_mem = s["bytes"] / PEAK_BYTES * 1e3
            row = {
                "name": name, "route": "cuda", "source": KERNELS[name][0],
                "replaces": KERNELS[name][1], "path": path,
                "launches": counts[path].get(name, 0), "max_abs_err": s["err"],
                "ms": s["ms"], "plain_ms": s["plain_ms"],
                "bound_ms": max(t_mul, t_mem),
                "bound_by": "operations" if t_mul >= t_mem else "bytes",
                "library_ms": None,
            }
            if HOME[name] == path:
                rows.append(row)
            log(f"  {path:11s} {name:22s} launches {row['launches']:3d}  "
                f"kernel {s['ms']:10.3f} ms  plain {s['plain_ms']:10.1f} ms  "
                f"bound {row['bound_ms']:8.3f} ms ({row['bound_by']})")
    if {r["name"] for r in rows} != set(KERNELS):
        raise SystemExit("a kernel has no timed row")

    for power in (20, 17, 16, 14):
        log(f"phase 5: stage breakdown of one warm 2^{power} MSM "
            "(each stage fenced)")
        secs, total = stage_breakdown(*inputs[power])
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
    copy_breakdown("points", inputs[20][0])
    copy_breakdown("scalars", inputs[20][1])
    if profile:
        from webgpu_msm_bls12_377_tpu_torch import compute_msm

        for label, fn, args in (("2^20 tree", compute_msm, inputs[20]),
                                ("2^17 stream", compute_msm, inputs[17]),
                                ("2^14 fused", compute_msm, inputs[14]),
                                (f"2^20 batch of {BATCH_SETS}", batch_msm,
                                 (inputs[20][0], sets[20])),
                                ("2^16 legacy", pippenger_msm, inputs[16]),
                                ("2^16 naive", naive_msm, inputs[16])):
            wall, busy, top = device_busy_share(fn, args)
            log(f"profile {label}: wall {wall * 1e3:.2f} ms, device busy "
                f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f} %), idle "
                f"{100 * (1 - busy / wall):.1f} %")
            for key, ms, count in top:
                log(f"  {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
