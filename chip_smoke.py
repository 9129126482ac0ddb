#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which fails the run on any error:
  1. the card's name and power limit (nvidia-smi), and the build of every
     kernel source under webgpu_msm_bls12_377_tpu_torch/csrc/ with nvcc;
  2. every kernel entry point against its plain PyTorch form on random
     inputs of a few thousand lanes (and a small real plan for the tree,
     finish and stream kernels): bit-exact equality;
  3. every path through the entry points a user calls, on the
     distinct-point bench cases held against the pinned goldens in
     test-data/goldens.json: compute_msm at 2^16 and 2^17 (stream path,
     chunk 15) and at 2^18 and 2^20 (hybrid tree, chunk 15 and 16),
     PippengerMsmEngine (legacy path) and NaiveMsmEngine at 2^16, and a
     running-sum chain through the one kernel no engine calls, held
     against the bigint oracle.  Cold time,
     median of 3 warm runs, and each kernel's launches in one run (counts
     zeroed just before, read just after); every path must launch the
     kernels it names, and together the paths cover every kernel;
  4. one more run of each path (2^20 tree, 2^17 stream, 2^16 legacy, 2^16
     naive, the chain) in which every kernel launch is timed with CUDA
     events and repeated with its plain form on the same inputs, which
     must agree bit for bit: per-kernel time, plain time and the bound
     (least time for the same work on an H100 SXM);
  5. one more 2^20, 2^17 and 2^16 MSM with every engine stage fenced and
     timed; with --profile, also torch.profiler over one 2^20, 2^17,
     Pippenger and naive run: the device's busy and idle share and the
     ops that take the most device time.
The second-to-last line is the per-kernel JSON record, the last line
{"ok": true, "device": {...}}.  Exits nonzero, printing no result, when
no CUDA device is present or the package is missing.
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
BENCH = ((16, 15), (17, 15), (18, 15), (20, 16))  # (power, chunk)
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
}
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


def drive(label, path, fn, args, want):
    """Phase 3 for one case: counts zeroed just before the cold run and
    read just after; the result against `want` (the pinned golden, or the
    oracle's result); 3 warm runs.  Returns the launches of the cold run."""
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K

    K.reset_launches()
    got, cold = fenced(fn, *args)
    launches = dict(K.launches)
    if got != want:
        raise SystemExit(f"{label}: result differs from the expected one")
    warm = []
    for _ in range(3):
        again, dt = fenced(fn, *args)
        if again != want:
            raise SystemExit(f"{label}: warm result differs")
        warm.append(dt)
    med = statistics.median(warm)
    n = args[0].shape[-1]
    log(f"  {label}: result OK; cold {cold:.3f} s, warm median {med:.4f} s "
        f"({[round(w, 4) for w in warm]}), {n / med:,.0f} points/s")
    log(f"  {label} launches per run: {launches}")
    missing = set(PATHS[path]) - {k for k, v in launches.items() if v}
    if missing:
        raise SystemExit(f"{label}: kernels not launched: {missing}")
    return launches


def main_paths(goldens):
    """Phase 3; returns the inputs by power and the launch counts by path
    (of the largest case of each path)."""
    from webgpu_msm_bls12_377_tpu_torch import compute_msm
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine
    from webgpu_msm_bls12_377_tpu_torch.ops.decompose import choose_chunk_size

    counts, inputs = {}, {}
    auto = CuzkMsmEngine()
    for power, chunk in BENCH:
        t0 = time.perf_counter()
        pw, sw = inputs[power] = bench_case(power)
        log(f"  2^{power}: bench inputs built on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        x_hex, y_hex = goldens[f"bls12_377:{power}:bench-{power}"][:2]
        want = {"x": int(x_hex, 16), "y": int(y_hex, 16)}
        path = auto._select_smvp(chunk, 1 << power)
        if choose_chunk_size(1 << power) != chunk or path != (
                "tree" if power >= 18 else "stream"):
            raise SystemExit(f"2^{power}: the default policy gives chunk "
                             f"{choose_chunk_size(1 << power)}, path {path}")
        counts[path] = drive(f"2^{power} compute_msm ({path}, chunk {chunk})",
                             path, compute_msm, (pw, sw), want)
        if power == 16:
            counts["legacy"] = drive("2^16 PippengerMsmEngine (legacy)",
                                     "legacy", pippenger_msm, (pw, sw), want)
            counts["naive"] = drive("2^16 NaiveMsmEngine", "naive",
                                    naive_msm, (pw, sw), want)
            counts["running_sum"] = drive("2^16 running-sum chain",
                                          "running_sum", running_sum_chain,
                                          (pw,), running_sum_oracle(pw))
    covered = {k for names in PATHS.values() for k in names}
    if covered != set(KERNELS):
        raise SystemExit(f"no path names {set(KERNELS) - covered}")
    return counts, inputs


def timed_paths(inputs):
    """Phase 4: each kernel launch of one run of every path timed,
    repeated with its plain form, compared, and its work counted.
    Returns stats[path][kernel]."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.models import cuzk, naive
    from webgpu_msm_bls12_377_tpu_torch.ops import bpr, buckets, convert
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
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
    K_STREAM = S.accumulate_buckets_streamed
    patches = [
        (convert, "mont_mul_const", mmc), (cuzk, "mont_mul_const", mmc),
        (naive, "mont_mul_const", mmc),
        (T, "run_tree_level", tree), (T, "packed_finish", finish),
        (cuzk, "accumulate_buckets_streamed", stream),
        (bpr, "bpr_running_add", running), (bpr, "bpr_double", double),
        (bpr, "bpr_masked_add_double", masked), (bpr, "bpr_add", add),
        (buckets, "masked_add_mixed", mixed),
        (naive, "fused_add", cadd), (naive, "masked_add_and_double", cmasked),
        (K, "fused_running_add", crunning), (K, "bpr_running_add", running),
    ]
    runs = (("tree", run_msm, inputs[20]), ("stream", run_msm, inputs[17]),
            ("legacy", pippenger_msm, inputs[16]),
            ("naive", naive_msm, inputs[16]),
            ("running_sum", running_sum_chain, inputs[16][:1]))
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
#: tree and stream paths (a path reports the stages it ran)
STAGES = ("words_to_device", "mont_point_table", "decompose_scalars_signed",
          "build_bucket_plan", "build_hybrid_plan", "build_signed_table",
          "tree_smvp_hybrid", "build_stream_layout",
          "accumulate_buckets_streamed", "bpr_order", "permute_buckets",
          "reduce_buckets_prearranged", "mont_mul_const", "_finalize")


def stage_breakdown(pw, sw):
    """Phase 5: one warm MSM with every engine stage fenced by
    torch.cuda.synchronize() and timed on the host clock.  "other" is the
    rest of the call: wire-format checks and chunk choice."""
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
    with patched([(cuzk, s, fence(s, getattr(cuzk, s))) for s in STAGES[:-1]]
                 + [(eng, "_finalize", fence("_finalize", eng._finalize))]):
        _, total = run_msm(pw, sw)
    secs = {k: v for k, v in secs.items() if v}
    secs["other"] = total - sum(secs.values())
    return secs, total


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
    counts, inputs = main_paths(goldens)

    log("phase 4: per-kernel time at each path's shapes "
        "(2^20 tree, 2^17 stream, 2^16 legacy, naive and chain)")
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

    for power in (20, 17, 16):
        log(f"phase 5: stage breakdown of one warm 2^{power} MSM "
            "(each stage fenced)")
        secs, total = stage_breakdown(*inputs[power])
        for name, s in sorted(secs.items(), key=lambda kv: -kv[1]):
            log(f"  {name:28s} {s * 1e3:9.2f} ms  {100 * s / total:5.1f} %")
        log(f"  total (fenced)               {total * 1e3:9.2f} ms")
    if profile:
        from webgpu_msm_bls12_377_tpu_torch import compute_msm

        for label, fn, args in (("2^20 tree", compute_msm, inputs[20]),
                                ("2^17 stream", compute_msm, inputs[17]),
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
