#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which fails the run on any error:
  1. the card's name and power limit (nvidia-smi), and the build of every
     kernel source under webgpu_msm_bls12_377_tpu_torch/csrc/ with nvcc;
  2. every kernel entry point against its plain PyTorch form on random
     inputs of a few thousand lanes (and a small real plan for the tree
     and finish kernels): bit-exact equality;
  3. the main path, compute_msm, on the distinct-point bench cases
     bls12_377:18:bench-18 (chunk 15) and bls12_377:20:bench-20 (chunk
     16), held against the pinned goldens in test-data/goldens.json:
     cold time, median of 3 warm runs, and each kernel's launches in one
     MSM (counts zeroed just before the run, read just after);
  4. one more 2^20 MSM in which every kernel launch is timed with CUDA
     events and repeated with its plain form on the same inputs, which
     must agree bit for bit: per-kernel time, plain time and the bound
     (least time for the same work on an H100 SXM) per MSM;
  5. one more 2^20 MSM with every engine stage fenced and timed; with
     --profile, also torch.profiler over one MSM: the device's busy and
     idle share and the ops that take the most device time.
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
DBL = 8 * MM  # double_lazy
PT = 39 * 4  # bytes of one projective point
BENCH = ((18, 15), (20, 16))  # (power, chunk)

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
}


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
    return torch.cat(planes).cuda()


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
                         generator=torch.Generator().manual_seed(1)).cuda()
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
    table = T.build_tree_table(rand_plane(rng, 26, npts, P))
    sw = torch.tensor(
        [[rng.randrange(1 << 32) for _ in range(npts)] for _ in range(8)],
        dtype=torch.int64,
    )
    sw[7] &= (1 << 29) - 1
    digits = decompose_scalars_signed(sw.cuda(), chunk, windows)
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
    kw = torch.from_numpy(ints_to_words(ks, 8).astype(np.int64)).cuda()
    g1 = C.G1Ops()
    gen = F.ints_to_plane([MP.to_mont(GX), MP.to_mont(GY)]).cuda()
    temp = C.merge(g1.from_affine((gen[:, :1].expand(13, n),
                                   gen[:, 1:].expand(13, n))))
    res = C.merge(g1.zero(n, "cuda"))
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


def run_msm(pw, sw):
    import torch

    from webgpu_msm_bls12_377_tpu_torch import compute_msm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = compute_msm(pw, sw)
    torch.cuda.synchronize()
    return got, time.perf_counter() - t0


def main_path(goldens):
    """Phase 3; returns the 2^20 inputs and launch counts per MSM."""
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K

    counts, inputs = {}, None
    for power, chunk in BENCH:
        t0 = time.perf_counter()
        pw, sw = bench_case(power)
        log(f"  2^{power}: bench inputs built on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        x_hex, y_hex = goldens[f"bls12_377:{power}:bench-{power}"][:2]
        want = {"x": int(x_hex, 16), "y": int(y_hex, 16)}
        K.reset_launches()
        got, cold = run_msm(pw, sw)
        launches = dict(K.launches)
        if got != want:
            raise SystemExit(f"2^{power}: result differs from the golden")
        warm = []
        for _ in range(3):
            again, dt = run_msm(pw, sw)
            if again != want:
                raise SystemExit(f"2^{power}: warm result differs")
            warm.append(dt)
        med = statistics.median(warm)
        log(f"  2^{power} chunk {chunk}: golden OK; cold {cold:.3f} s, "
            f"warm median {med:.4f} s ({[round(w, 4) for w in warm]}), "
            f"{(1 << power) / med:,.0f} points/s")
        log(f"  2^{power} launches per MSM: {launches}")
        missing = set(KERNELS) - {k for k, v in launches.items() if v}
        if missing:
            raise SystemExit(f"2^{power}: kernels not launched: {missing}")
        counts, inputs = launches, (pw, sw)
    return counts, inputs


def timed_path(pw, sw):
    """Phase 4: each launch of one 2^20 MSM timed, repeated with its plain
    form, compared, and its work counted."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.models import cuzk
    from webgpu_msm_bls12_377_tpu_torch.ops import bpr, convert
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_tree as T

    stats = {k: {"ms": 0.0, "plain_ms": 0.0, "err": 0, "muls": 0, "bytes": 0}
             for k in KERNELS}

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
        s = stats[name]
        s["ms"] += ms
        s["plain_ms"] += pms
        s["err"] = max([s["err"]] + [max_abs_err(x, y) for x, y in zip(got, want)])
        s["muls"] += muls
        s["bytes"] += nbytes
        return got if len(got) > 1 else got[0]

    def mmc(a, y):
        n = a.numel() // 13
        return record("mont_mul_const", K.mont_mul_const, K.mont_mul_const_plain,
                      (a, y), n * MM, 2 * 52 * n)

    def tree(arr_in, level_map, mode, last=False, sorted_vals=None):
        m = level_map.to(torch.int64)
        invalid = (m & T.FLAG_INVALID) != 0
        single = ((m & T.FLAG_SINGLE) != 0) & ~invalid
        pairs = int((~invalid & ~single).sum())
        reads = 2 * pairs + int(single.sum())
        t = m.shape[0]
        if mode == "aff":
            muls, nbytes = pairs * ADD_AFF, reads * (4 + 104) + t * (4 + PT)
        else:
            muls, nbytes = pairs * ADD_FULL, reads * PT + t * (4 + PT)
        return record(f"tree_level_{mode}", K_TREE, T.tree_level_plain,
                      (arr_in, level_map, mode, last, sorted_vals), muls, nbytes)

    def finish(plane, layout):
        lens = layout.lens_rk
        nodes, nb = int(lens.sum()), lens.numel()
        # a bucket of c nodes needs c - 1 adds (the kernel's first add,
        # into the identity, is not part of the function)
        adds = int((lens.to(torch.int64) - 1).clamp(min=0).sum())
        return record(
            "packed_finish", lambda p, s, l: K_FINISH(p, layout),
            S.packed_finish_plain, (plane, layout.starts_rk, lens),
            adds * ADD_FULL, nodes * PT + nb * (8 + PT))

    def running(m, g, b):
        n = m.shape[1]
        return record("bpr_running_add", K.bpr_running_add, K.running_add_plain,
                      (m, g, b), 2 * n * ADD_FULL, 5 * n * PT)

    def double(a):
        n = a.shape[1]
        return record("bpr_double", K.bpr_double, K.double_plain, (a,),
                      n * DBL, 2 * n * PT)

    def masked(r, t, bits):
        n = r.shape[1]
        return record("bpr_masked_add_double", K.bpr_masked_add_double,
                      K.masked_add_double_plain, (r, t, bits),
                      int(bits.sum()) * ADD_FULL + n * DBL, 4 * n * PT + 4 * n)

    def add(a, b):
        n = a.shape[1]
        return record("bpr_add", K.bpr_add, K.add_plain, (a, b),
                      n * ADD_FULL, 3 * n * PT)

    K_TREE, K_FINISH = T.run_tree_level, T.packed_finish
    with patched([(convert, "mont_mul_const", mmc), (cuzk, "mont_mul_const", mmc),
                  (T, "run_tree_level", tree), (T, "packed_finish", finish),
                  (bpr, "bpr_running_add", running), (bpr, "bpr_double", double),
                  (bpr, "bpr_masked_add_double", masked), (bpr, "bpr_add", add)]):
        run_msm(pw, sw)
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


#: the engine's stages, as msm_device and compute_msm call them
STAGES = ("words_to_device", "mont_point_table", "decompose_scalars_signed",
          "build_bucket_plan", "build_hybrid_plan", "build_tree_table",
          "tree_smvp_hybrid", "bpr_order", "permute_buckets",
          "reduce_buckets_prearranged", "mont_mul_const", "_finalize")


def stage_breakdown(pw, sw):
    """Phase 5: one warm 2^20 MSM with every engine stage fenced by
    torch.cuda.synchronize() and timed on the host clock.  "other" is the
    rest of the call: wire-format checks and chunk choice."""
    import torch

    from webgpu_msm_bls12_377_tpu_torch.models import cuzk

    secs = dict.fromkeys(STAGES, 0.0)

    def fenced(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            return out
        return run

    eng = cuzk.CuzkMsmEngine
    with patched([(cuzk, s, fenced(s, getattr(cuzk, s))) for s in STAGES[:-1]]
                 + [(eng, "_finalize", fenced("_finalize", eng._finalize))]):
        _, total = run_msm(pw, sw)
    secs["other"] = total - sum(secs.values())
    return secs, total


def device_busy_share(pw, sw):
    """--profile: torch.profiler over one warm 2^20 MSM; returns (wall s,
    device-busy s summed over kernels and copies, top ops by device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, total = run_msm(pw, sw)
    events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    return total, busy, [(e.key, e.self_device_time_total / 1e3, e.count)
                         for e in events[:12]]


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

    log("phase 3: main path, compute_msm against the pinned goldens")
    counts, (pw, sw) = main_path(goldens)

    log("phase 4: per-kernel time at the 2^20 main-path shapes")
    stats = timed_path(pw, sw)
    rows = []
    for name, (src, replaces) in KERNELS.items():
        s = stats[name]
        if s["err"]:
            raise SystemExit(f"{name}: kernel and plain differ at 2^20")
        t_mul = s["muls"] / PEAK_MULS * 1e3
        t_mem = s["bytes"] / PEAK_BYTES * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts.get(name, 0), "max_abs_err": s["err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": max(t_mul, t_mem),
            "bound_by": "operations" if t_mul >= t_mem else "bytes",
            "library_ms": None,
        })
        log(f"  {name:24s} launches {counts.get(name, 0):3d}  kernel "
            f"{s['ms']:10.3f} ms  plain {s['plain_ms']:10.1f} ms  bound "
            f"{max(t_mul, t_mem):8.3f} ms ({rows[-1]['bound_by']})")

    log("phase 5: stage breakdown of one warm 2^20 MSM (each stage fenced)")
    secs, total = stage_breakdown(pw, sw)
    for name, s in sorted(secs.items(), key=lambda kv: -kv[1]):
        log(f"  {name:28s} {s * 1e3:9.2f} ms  {100 * s / total:5.1f} %")
    log(f"  total (fenced)               {total * 1e3:9.2f} ms")
    if profile:
        wall, busy, top = device_busy_share(pw, sw)
        log(f"profile: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
            f"({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %")
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
