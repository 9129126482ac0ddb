"""Scripted benchmark sweep: a cold and warm runs for each power, a
Markdown table and an optional CSV: the JAX package's harness/sweep.py
on the port (the reference's full_benchmarks.ts protocol).

For each power: the inputs staged on the engine's device once (msm_device
then copies nothing, as the JAX harness's inputs are put on the device
first), one cold run, then `runs` warm runs, each msm_device plus the
readback and the host Horner (_finalize); the result held against the
expected point.  Distinct-point inputs from harness/testdata.py
make_bench_case by default (held against the pinned goldens), or
--same-point: the generator in every lane, 253-bit scalars from
np.random.RandomState(42).  The multi-device scaling mode (--devices,
run_scaling) waits for the port's multi-device slice (ROADMAP.md).

Run: python -m webgpu_msm_bls12_377_tpu_torch.harness.sweep --powers 16 20
     python -m webgpu_msm_bls12_377_tpu_torch.harness.sweep --powers 6 8 \\
         --runs 1 --device cpu                       # plain forms
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..models.cuzk import SMVP_MODES, CuzkMsmEngine
from ..ops.convert import ints_to_words
from ..params import CurveId
from ..reference import curve as ocurve
from . import testdata


def _same_point_inputs(curve, n, rng_seed=42):
    """(point words, scalar words, want): the generator in all n lanes,
    random scalars below 2^253, want = (sum of the scalars) * G."""
    if curve == CurveId.BLS12_377:
        gx, gy = ocurve.g1_to_affine(ocurve.G1_GENERATOR)
        coord_words = 12
    else:
        gx, gy = ocurve.ed_to_affine(ocurve.ED_GENERATOR)
        coord_words = 8
    base = np.stack(
        [ints_to_words([gx], coord_words), ints_to_words([gy], coord_words)]
    )
    point_words = np.broadcast_to(base, (2, coord_words, n)).copy()
    rng = np.random.RandomState(rng_seed)
    scalar_words = rng.randint(0, 1 << 32, size=(8, n), dtype=np.uint64).astype(
        np.uint32
    )
    scalar_words[7] &= 0x1FFFFFFF
    # a row's sum of n words < 2^32 fits a uint64
    total = sum(int(s) << (32 * i)
                for i, s in enumerate(scalar_words.sum(axis=1, dtype=np.uint64)))
    if curve == CurveId.BLS12_377:
        want = ocurve.g1_to_affine(
            ocurve.g1_scalar_mult(ocurve.G1_GENERATOR, total)
        )
    else:
        want = ocurve.ed_to_affine(
            ocurve.ed_scalar_mult(ocurve.ED_GENERATOR, total)
        )
    return point_words, scalar_words, want


def run_power(engine, curve, power, num_runs, same_point=False):
    n = 1 << power
    if same_point:
        point_words, scalar_words, want = _same_point_inputs(curve, n)
    else:
        case = testdata.make_bench_case(curve, power, device=engine.device)
        point_words, scalar_words = case.point_words, case.scalar_words
        want = case.expected

    chunk_size = engine._chunk_for(n)
    points, scalars = testdata.staged_inputs(engine, point_words,
                                             scalar_words)

    def once():
        t0 = time.perf_counter()
        coords = engine.msm_device(points, scalars, chunk_size)
        result = engine._finalize(coords, chunk_size)  # the readback fences
        return result, time.perf_counter() - t0

    result, cold_s = once()
    warm = []
    for _ in range(num_runs):
        result, dt = once()
        warm.append(dt)

    ok = (result["x"], result["y"]) == tuple(want)

    return {
        "power": power,
        "n": n,
        "chunk": chunk_size,
        "path": engine._select_smvp(chunk_size, n),
        "cold_s": round(cold_s, 3),
        "warm_s": [round(t, 4) for t in warm],
        "mean_warm_s": round(float(np.mean(warm)), 4),
        "mean_with_cold_s": round(float(np.mean(warm + [cold_s])), 4),
        "points_per_s": round(n / float(np.mean(warm)), 1),
        "verified": ok,
        "distinct_points": not same_point,
    }


def markdown_table(rows) -> str:
    lines = [
        "| power | n | cold (s) | mean warm (s) | points/s | verified |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| 2^{r['power']} | {r['n']} | {r['cold_s']} | "
            f"{r['mean_warm_s']} | {r['points_per_s']} | {r['verified']} |"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--powers", type=int, nargs="+", default=[16, 17, 18, 19, 20])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--curve", default="bls12_377",
                    choices=["bls12_377", "edwards_bls12"])
    ap.add_argument("--csv", default=None)
    ap.add_argument("--same-point", action="store_true",
                    help="the generator in every lane (default: distinct "
                         "points against the pinned goldens)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain forms)")
    ap.add_argument("--smvp-mode", default="auto", choices=SMVP_MODES,
                    help="SMVP path (A/B sweeps)")
    ap.add_argument("--tree-finish", type=int, default=None, metavar="K",
                    help="tree mode: K pairwise levels then the packed "
                         "finish")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="window size (default: the tuned one, else the "
                         "size policy)")
    args = ap.parse_args(argv)

    curve = CurveId(args.curve)
    engine = CuzkMsmEngine(
        curve, chunk_size=args.chunk_size, smvp_mode=args.smvp_mode,
        tree_finish=args.tree_finish, device=args.device,
    )
    rows = []
    for power in args.powers:
        row = run_power(engine, curve, power, args.runs,
                        same_point=args.same_point)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(markdown_table(rows))
    if args.csv:
        with open(args.csv, "w") as f:
            f.write("power,n,cold_s,mean_warm_s,points_per_s,verified\n")
            for r in rows:
                f.write(
                    f"{r['power']},{r['n']},{r['cold_s']},"
                    f"{r['mean_warm_s']},{r['points_per_s']},{r['verified']}\n"
                )


if __name__ == "__main__":
    main()
