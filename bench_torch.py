#!/usr/bin/env python3
"""MSM throughput of the PyTorch/CUDA port (webgpu_msm_bls12_377_tpu_torch)
on one device: bench.py's protocol and JSON line, for the port.

    python3 bench_torch.py [--n 1048576] [--runs 5] [--curve bls12_377]
                           [--device cuda] [options]

On the card the kernel libraries are built first (build_s: zero where
this checkout has them built).  Then one cold call (cold_s) and --runs
warm calls, each engine.compute_msm(points, scalars) from host words (or
with --bytes from the reference's wire bytes) to the affine result,
between two device synchronizations, the copy to the device included.
Every result, cold and warm, is held against the case's expected value
unless --no-check: the distinct-point bench case of the port's
harness/testdata.py (points k_i * G made on the device, the known-k
identity, goldens.json where it pins the case), its zipf case with
--zipf, or with --same-point the generator in every lane.
input_transfer_s is one fenced copy of points and scalars to the device,
host_finalize_s one host Horner (_finalize).  --batch K times
compute_msm_batch over K scalar sets against compute_msm per set.

Prints '#' comment lines, then last one JSON object: {"metric", "value"
(points/s), "unit", "vs_baseline" (value / 524288, bench.py's yardstick),
"detail"}.  A wrong result, or --device cuda without a CUDA device, exits
nonzero and prints no JSON line; nothing falls back to the CPU.
--device cpu runs the kernels' plain forms (for tests, at small n).
--sharded runs parallel/mesh.py's ShardedMsmEngine over make_mesh() (every
local CUDA device; with --device cpu two CPU shards) and reports
n_devices = D, the shard count.
bench.py stays the JAX package's bench.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BASELINE_POINTS_PER_SEC = 524288.0  # bench.py's: 2^20 points in 2 s


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--curve", default="bls12_377",
                    choices=["bls12_377", "edwards_bls12"])
    ap.add_argument("--chunk-size", type=int, default=None)
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--same-point", action="store_true",
                    help="every point the generator, expected (sum of "
                         "s_i) * G (blind to a permutation of the points)")
    ap.add_argument("--zipf", type=int, default=None, metavar="POOL_BITS",
                    help="scalars drawn zipf(1.2) from a pool of "
                         "2^POOL_BITS values over the distinct points")
    ap.add_argument("--smvp-mode", default="auto",
                    choices=["auto", "tree", "stream", "fused", "legacy"])
    ap.add_argument("--tree-finish", type=int, default=None, metavar="K",
                    help="the hybrid tree's finish level (default: the "
                         "engine's)")
    ap.add_argument("--batch", type=int, default=0, metavar="K",
                    help="K scalar sets over one point set: "
                         "compute_msm_batch against compute_msm per set")
    ap.add_argument("--batch-host-inputs", action="store_true",
                    help="batch mode from host words through the public "
                         "calls; by default points and sets are staged on "
                         "the device first and the engine's batch stages "
                         "run on them (bench.py's protocol)")
    ap.add_argument("--bytes", action="store_true",
                    help="inputs as the reference's wire bytes")
    ap.add_argument("--debug", action="store_true",
                    help="engine.debug_check at the full n before timing")
    ap.add_argument("--prewarm", action="store_true",
                    help="engine.prewarm in a background thread while the "
                         "case is made and staged; reports the part of it "
                         "not hidden behind that (prewarm_extra_s)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="torch.profiler over one warm call, a Chrome "
                         "trace written to DIR")
    ap.add_argument("--cache-dir", default=os.path.join(ROOT, "build",
                                                        "testdata"),
                    help="where the cases' words are kept (.npz)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain forms, for tests)")
    ap.add_argument("--sharded", action="store_true",
                    help="the sharded engine (parallel/mesh.py) over every "
                         "local CUDA device (--device cpu: two CPU shards)")
    return ap.parse_args(argv)


def card_line() -> str | None:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def same_point_case(curve, n):
    """The generator in every lane, scalars from np.random.RandomState(42)
    below 2^253; expected (sum of s_i mod r) * G."""
    import numpy as np

    from webgpu_msm_bls12_377_tpu_torch.harness import testdata
    from webgpu_msm_bls12_377_tpu_torch.ops.convert import ints_to_words
    from webgpu_msm_bls12_377_tpu_torch.params import CurveId
    from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv

    g = crv.G1_GENERATOR if curve == CurveId.BLS12_377 else crv.ED_GENERATOR
    cw = 12 if curve == CurveId.BLS12_377 else 8
    base = np.stack([ints_to_words([g.x], cw), ints_to_words([g.y], cw)])
    pw = np.ascontiguousarray(np.broadcast_to(base, (2, cw, n)))
    sw = np.random.RandomState(42).randint(
        0, 1 << 32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    sw[7] &= 0x1FFFFFFF
    ones = np.zeros((8, n), dtype=np.uint32)
    ones[0] = 1
    got = testdata.msm_oracle(sw, ones, curve)
    return pw, sw, (got["x"], got["y"])


class MsmMismatch(Exception):
    """An MSM result differs from the case's expected value."""


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (pass --device cpu for the plain "
              "forms)", file=sys.stderr)
        return 1
    from webgpu_msm_bls12_377_tpu_torch.harness import testdata
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import (
        CuzkMsmEngine,
        words_to_device,
    )
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
    from webgpu_msm_bls12_377_tpu_torch.ops.decompose import choose_chunk_size
    from webgpu_msm_bls12_377_tpu_torch.params import CurveId
    from webgpu_msm_bls12_377_tpu_torch.utils.timing import fence

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    curve = CurveId(args.curve)
    n = args.n
    power = n.bit_length() - 1
    if n != 1 << power and not args.same_point:
        print("bench_torch: --n must be a power of two (or use --same-point)",
              file=sys.stderr)
        return 1
    chunk = args.chunk_size or choose_chunk_size(n)
    build_s = None
    if dev.type == "cuda":
        smi = card_line()
        if smi:
            print(f"# card: {smi}", flush=True)
        _, build_s = K.build_all()
    if args.sharded:
        if args.batch:
            print("bench_torch: --batch with --sharded: use "
                  "engine.compute_msm_batch", file=sys.stderr)
            return 1
        from webgpu_msm_bls12_377_tpu_torch.parallel.mesh import (
            ShardedMsmEngine,
            make_mesh,
        )

        mesh = make_mesh(["cpu"] * 2 if dev.type == "cpu" else None)
        engine = ShardedMsmEngine(curve, mesh=mesh,
                                  chunk_size=chunk, smvp_mode=args.smvp_mode,
                                  tree_finish=args.tree_finish)
        n_devices = engine.mesh.size
        path = engine._shard_path(chunk, -(-n // n_devices))
    else:
        engine = CuzkMsmEngine(curve, chunk_size=chunk,
                               smvp_mode=args.smvp_mode,
                               tree_finish=args.tree_finish, device=dev)
        n_devices = 1
        path = engine._select_smvp(chunk, n)

    warm_thread = None
    if args.prewarm:
        warm_thread = engine.prewarm(n, chunk, background=True)

    if args.batch:
        return bench_batch(args, engine, curve, n, chunk, path, build_s,
                           warm_thread)

    t_case = time.perf_counter()
    if args.zipf is not None:
        case = testdata.make_zipf_case(curve, power, pool_bits=args.zipf,
                                       device=dev, cache_dir=args.cache_dir)
        pw, sw, want = case.point_words, case.scalar_words, case.expected
        print(f"# zipf case 2^{power}: pool 2^{args.zipf}, alpha 1.2",
              flush=True)
    elif args.same_point:
        pw, sw, want = same_point_case(curve, n)
        print(f"# same-point case n={n}: the generator in every lane",
              flush=True)
    else:
        case = testdata.make_bench_case(curve, power, device=dev,
                                        cache_dir=args.cache_dir)
        pw, sw, want = case.point_words, case.scalar_words, case.expected
        print(f"# distinct-point case 2^{power}: golden_pinned="
              f"{case.golden_pinned} oracle_checked={case.oracle_checked}",
              flush=True)
    pts, scs = testdata.to_wire(pw, sw) if args.bytes else (pw, sw)
    print(f"# case made in {time.perf_counter() - t_case:.3f} s; {path} path, "
          f"chunk {chunk}, {'wire bytes' if args.bytes else 'word arrays'}",
          flush=True)

    prepared = engine._prepare_points(pts), engine._prepare_scalars(scs)
    sync()
    t0 = time.perf_counter()
    staged = [words_to_device(w, dev) for w, _ in prepared]
    fence(staged)
    input_transfer_s = time.perf_counter() - t0
    prewarm_extra_s = None
    if warm_thread is not None:
        t0 = time.perf_counter()
        warm_thread.join()
        prewarm_extra_s = time.perf_counter() - t0

    if args.debug:
        t0 = time.perf_counter()
        checks = engine.debug_check(pts, scs, chunk)
        print(f"# debug stage checks ({time.perf_counter() - t0:.3f} s): "
              f"{checks}", flush=True)

    def once():
        sync()
        t0 = time.perf_counter()
        got = engine.compute_msm(pts, scs)
        sync()
        dt = time.perf_counter() - t0
        if not args.no_check and (got["x"], got["y"]) != want:
            raise MsmMismatch(f"result {got} differs from the expected {want}")
        return dt

    try:
        cold_s = once()
        warm = [once() for _ in range(args.runs)]
    except MsmMismatch as e:
        print(f"bench_torch: {e}", file=sys.stderr)
        return 1
    coords = engine.msm_device(*prepared, chunk)
    sync()
    t0 = time.perf_counter()
    engine._finalize(coords, chunk)
    host_finalize_s = time.perf_counter() - t0

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            once()
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, f"bench_torch_{power}.json")
        prof.export_chrome_trace(trace)
        print(f"# profiler trace written to {trace}", flush=True)

    mean_warm = float(np.mean(warm)) if warm else cold_s
    value = n / mean_warm
    detail = {
        "n": n, "chunk_size": chunk, "mean_warm_s": mean_warm,
        "cold_s": cold_s, "host_finalize_s": host_finalize_s,
        "input_transfer_s": input_transfer_s, "runs": args.runs,
        "device": dev.type, "n_devices": n_devices,
        "checked": not args.no_check, "build_s": build_s, "path": path,
    }
    if prewarm_extra_s is not None:
        detail["prewarm_extra_s"] = prewarm_extra_s
    print(json.dumps({
        "metric": f"msm_throughput_2^{power}_{args.curve}", "value": value,
        "unit": "points/s", "vs_baseline": value / BASELINE_POINTS_PER_SEC,
        "detail": detail}))
    return 0


def bench_batch(args, engine, curve, n, chunk, path, build_s, warm_thread):
    """--batch K: compute_msm_batch over K scalar sets against compute_msm
    per set (--batch-host-inputs), or by default the engine's batch stages
    and msm_device per set on points and sets staged on the device first;
    each timed from a synchronized device to the affine results, every
    result held against the batch case's expected values."""
    import numpy as np
    import torch

    from webgpu_msm_bls12_377_tpu_torch.harness import testdata
    from webgpu_msm_bls12_377_tpu_torch.models.cuzk import words_to_device

    dev = engine.device
    k = args.batch
    power = n.bit_length() - 1
    case = testdata.make_batch_case(curve, power, k, device=dev,
                                    cache_dir=args.cache_dir)
    pts, sets = case.point_words, case.scalar_sets
    if args.bytes:
        pts = testdata.to_wire(pts, sets[0])[0]
        sets = [testdata.to_wire(case.point_words, s)[1] for s in sets]
    print(f"# batch case 2^{power}: {k} sets, {path} path, chunk {chunk}",
          flush=True)
    if warm_thread is not None:
        warm_thread.join()

    if args.batch_host_inputs:
        def batched():
            return engine.compute_msm_batch(pts, sets)

        def serial():
            return [engine.compute_msm(pts, s) for s in sets]
    else:
        def stage(prepared):
            return words_to_device(prepared[0], dev), prepared[1]

        pts_dev = stage(engine._prepare_points(pts))
        sets_dev = [stage(engine._prepare_scalars(s)) for s in sets]

        def batched():
            shared = engine._batch_prep(path, pts_dev)
            return engine._batch_finish(
                engine._batch_sets(shared, sets_dev, chunk), chunk)

        def serial():
            return [engine._finalize(engine.msm_device(pts_dev, s, chunk),
                                     chunk) for s in sets_dev]

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if not args.no_check and [(g["x"], g["y"]) for g in got] != \
                case.expecteds:
            raise MsmMismatch("a batch result differs from its expected "
                              "value")
        return dt

    try:
        timed(batched)
        timed(serial)
        warm_b = [timed(batched) for _ in range(args.runs)]
        warm_s = [timed(serial) for _ in range(args.runs)]
    except MsmMismatch as e:
        print(f"bench_torch: {e}", file=sys.stderr)
        return 1
    tb, ts = float(np.mean(warm_b)), float(np.mean(warm_s))
    value = k * n / tb
    print(json.dumps({
        "metric": f"msm_batch{k}_throughput_2^{power}_{args.curve}",
        "value": value, "unit": "points/s",
        "vs_baseline": value / BASELINE_POINTS_PER_SEC,
        "detail": {
            "n": n, "batch": k, "chunk_size": chunk, "batched_s": tb,
            "serial_s": ts, "speedup_vs_serial": ts / tb,
            "host_inputs": args.batch_host_inputs, "runs": args.runs,
            "device": dev.type, "n_devices": 1, "checked": not args.no_check,
            "build_s": build_s, "path": path}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
