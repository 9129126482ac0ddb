"""Run one cell of BENCHMARK.json once and print its result line.

    python3 msm_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (setup_s, from this process's start): torch and the CUDA context,
the fixed bases (bases.py; made on a checkout's first run, then read from
msm_bench/.cache), the seed's scalar sets (gen/<kind>.py), the caller
(callers/<caller>.py) and one warm call of the cell's own shape, which on
a checkout's first run also builds the port's kernels (into <checkout>/
build).  The window: a closed loop of calls, one caller, for --seconds; a
call still running at the deadline runs to its end, is checked, and does
not count for the rate.  Then, with the program's state freed, the
reference (reference.py) computes every set the window's calls used and
each call's every result is compared with it.  With --trace 1 the window
runs under torch.profiler and the line carries the per-layer metrics
(metrics/<name>.py) instead of the end-to-end ones.

The last line of standard output is one JSON object; the last line of
standard error gives each number compared beside its limit.  No card, or
fewer than the cell asks for, or jax or the JAX package loaded: a nonzero
exit and no result line.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from msm_bench import bases as B  # noqa: E402
from msm_bench import cell as C  # noqa: E402
from msm_bench import reference, trace, work  # noqa: E402

#: top-level module names that must not be loaded when the result is made
BANNED = {"jax", "jaxlib", "flax", "webgpu_msm_bls12_377_tpu"}
CACHE = ROOT / "msm_bench" / ".cache"
#: bases checked against k_i G by double-and-add in every run
BASES_CHECKED = 16
#: the comparison's limit: wrong or missing results of the window's MSMs
WRONG_LIMIT = 0


@dataclasses.dataclass
class Call:
    t0: float
    t1: float
    sets: list[int]
    results: list | None
    error: str | None


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & BANNED)


def schedule(cell: C.Cell, k: int) -> list[int]:
    """The pool indices of call k's sets: the pool cycled in order."""
    s = cell.sets_per_call
    return [(k * s + j) % cell.traffic["pool_sets"] for j in range(s)]


def window(cell, caller, seconds: float, tracer) -> tuple[list[Call], float, float]:
    """The closed loop: calls 1, 2, ... until one starts at or after the
    deadline (call 0 was the warm-up); the first failure ends it."""
    calls: list[Call] = []
    start = time.perf_counter()
    deadline = start + seconds
    k = 1
    while not calls or time.perf_counter() < deadline:
        sets = schedule(cell, k)
        k += 1
        t0 = time.perf_counter()
        results = error = None
        try:
            with tracer.span():
                results = caller.call(sets)
        except Exception:  # the run's boundary: recorded, reported, ended
            error = traceback.format_exc()
        calls.append(Call(t0, time.perf_counter(), sets, results, error))
        if error:
            print(error, file=sys.stderr)
            break
    return calls, start, deadline


def rate(cell, calls: list[Call], start: float, deadline: float) -> float:
    """Points of the calls done by the deadline over the time to the last
    of them (one call that outlasts the window: that call alone)."""
    done = [c for c in calls if c.t1 <= deadline and c.error is None] or calls[:1]
    return sum(len(c.sets) for c in done) * cell.n / (done[-1].t1 - start)


def compare(bases, pool, calls: list[Call]) -> tuple[int, int]:
    """(wrong or missing results, results due) over every call's sets."""
    expected = {s: reference.msm(bases, pool[s])
                for s in sorted({s for c in calls for s in c.sets})}
    wrong = due = 0
    for c in calls:
        got = list(c.results or [])
        due += len(c.sets)
        wrong += sum(1 for i, s in enumerate(c.sets)
                     if i >= len(got) or tuple(got[i]) != expected[s])
        wrong += max(0, len(got) - len(c.sets))
    return wrong, due


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def least_seconds(cell, pool, calls, device_name: str) -> float | None:
    peaks = work.peaks_for(device_name)
    if peaks is None:
        return None
    bits = cell.config["scalar_bits"]
    c = work.window_width(cell.n, bits)
    per_set = {s: work.least_seconds(cell.config, peaks, cell.n,
                                     cell.sets_per_call,
                                     work.adds(pool[s], bits, c))
               for s in sorted({s for call in calls for s in call.sets})}
    return sum(per_set[s] for call in calls for s in call.sets)


def run_cell(cell: C.Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", wrap=None,
             cache: Path | None = CACHE) -> dict | None:
    """One run of the cell: the result line's object, or None where a
    banned module was loaded.  device "cpu" runs the port's plain forms
    (tests); wrap(caller, bases, pool) may stand in for the caller (the
    control, tests)."""
    import torch

    cuda = device == "cuda"
    os.environ["MSM_BUILD_DIR"] = str(ROOT / "build")
    if cache is not None:
        (Path(cache) / "autotune").mkdir(parents=True, exist_ok=True)
        os.environ["MSM_AUTOTUNE_DIR"] = str(Path(cache) / "autotune")
    stages = [("torch", time.perf_counter())]
    caller_cls = cell.caller().Caller
    bases = B.load(cell.config["curve"], cell.n,
                   None if cache is None else Path(cache) / "bases")
    stages.append(("bases", time.perf_counter()))
    pool = cell.generator().scalar_sets(cell.traffic, cell.config, seed)
    caller = caller_cls(cell.config, bases.wire.tobytes(),
                        [w.tobytes() for w in pool],
                        None if cuda else device)
    if wrap is not None:
        caller = wrap(caller, bases, pool)
    stages.append(("scalars", time.perf_counter()))
    caller.call(schedule(cell, 0))
    if cuda:
        torch.cuda.synchronize()
    stages.append(("warm call", time.perf_counter()))
    setup_s = stages[-1][1] - T0
    print("set-up: " + ", ".join(
        f"{name} {t - prev:.3f} s" for (name, t), prev in
        zip(stages, [T0] + [t for _, t in stages])), file=sys.stderr)

    tracer = trace.Tracer(traced, cuda)
    with tracer:
        calls, start, deadline = window(cell, caller, seconds, tracer)
    closed = time.perf_counter()
    points_per_s = rate(cell, calls, start, deadline)
    ms = sorted(1e3 * (c.t1 - c.t0) for c in calls)
    print(f"calls: {len(calls)}, the first three "
          f"{[round(1e3 * (c.t1 - c.t0), 1) for c in calls[:3]]} ms, median "
          f"{ms[len(ms) // 2]:.1f}, max {ms[-1]:.1f}", file=sys.stderr)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    metrics, breakdown = {}, None
    if traced:
        t = time.perf_counter()
        events = tracer.events()
        t_events = time.perf_counter()
        reading = trace.read(events, sum(len(c.sets) for c in calls),
                             [1e3 * (c.t1 - c.t0) for c in calls],
                             C.layer_maps())
        t_read = time.perf_counter()
        reading.least_s = least_seconds(cell, pool, calls, dev["kind"])
        print(f"trace: {len(events)} events in {t_events - t:.1f} s, read in "
              f"{t_read - t_events:.1f} s, yardstick "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
        events = None
        for m in cell.per_layer:
            value = C.metric_reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = reading.busy_s, reading.window_s
        breakdown = reading.breakdown
        tracer = reading = None
    else:
        found = {"points_per_s": points_per_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": found[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    del caller
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    wrong, due = compare(bases, pool, calls)
    print(f"after the window: {t - closed:.1f} s to the reference, which "
          f"took {time.perf_counter() - t:.1f} s", file=sys.stderr)
    picks = C.rng(seed, "bases-check").choice(
        bases.n, min(BASES_CHECKED, bases.n), replace=False)
    bad = reference.check_bases(bases, picks.tolist())
    if bad:
        raise SystemExit(f"the fixed bases {bad} are not k_i G: delete "
                         f"{cache} and run again")
    loaded = banned_modules()
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return None
    if cuda:
        dev["power_limit"] = power_limit()
    print(f"{cell.name} seed {seed}: {len(calls)} calls, {due} MSMs compared, "
          f"card {dev.get('power_limit') or dev['kind']}", file=sys.stderr)
    print(f"wrong_msms {wrong} limit {WRONG_LIMIT}", file=sys.stderr)
    out = {"correct": wrong <= WRONG_LIMIT and not any(c.error for c in calls),
           "attempted": due, "failed": wrong, "metrics": metrics,
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {"wrong_msms": {"value": wrong, "limit": WRONG_LIMIT}}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = C.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    if out is None:
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
