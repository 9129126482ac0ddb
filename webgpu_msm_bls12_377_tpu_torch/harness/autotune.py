"""On-device tuning of the window size and the SMVP path, with the winners
persisted: the JAX package's harness/autotune.py on the port.

Measure the candidates for a (curve, n) class on the engine's device,
check every result against the case's expected point, persist the winner,
and let engines consult the table: CuzkMsmEngine does by default
(autotune=True) for its window size (_chunk_for), its "auto" path
(_select_smvp) and its hybrid finish level (_tree_k); with no entry for
its device, curve and n it takes the static policy, the JAX engine's on a
TPU (models/cuzk.py:choose_chunk_size, TREE_MIN_N, K = 2).

Usage:
    python -m webgpu_msm_bls12_377_tpu_torch.harness.autotune --powers 16 20
    python -m webgpu_msm_bls12_377_tpu_torch.harness.autotune --powers 8 \\
        --candidates 4 5 --tune chunk --device cpu       # plain forms
    # or in code:
    eng = CuzkMsmEngine(curve)      # consults it (autotune=False: not)

The table is <repo>/.autotune_torch.json (MSM_AUTOTUNE_DIR overrides the
directory), keyed by device ("cuda/<card name>", or "cpu/cpu"), curve and
n.  It is the port's own file: the JAX package's .autotune.json also
holds "cpu/cpu" entries, which must not steer the port.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import time

import numpy as np
import torch

from ..models.cuzk import resolve_device
from ..ops.decompose import choose_chunk_size
from ..ops.smvp_stream import stream_supported
from ..utils.timing import fence

DEFAULT_CANDIDATES = (13, 15, 16)  # 12/14 left out, as in the JAX package:
                                   # their top windows are 1 bit wide
TABLE_NAME = ".autotune_torch.json"


def _table_path() -> str:
    d = os.environ.get("MSM_AUTOTUNE_DIR")
    if d is None:
        d = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
    return os.path.join(d, TABLE_NAME)


def device_key(device) -> str:
    """The table's key of a device: "cuda/<card name>" or "cpu/cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda/{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}/{dev.type}"


#: mtime-checked cache of the loaded table: engines consult the table on
#: every call, so a lookup must not parse the file each time
_TABLE_CACHE: dict = {"path": None, "mtime": None, "table": None}


def load_table(path: str | None = None) -> dict:
    path = path or _table_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return {}
    c = _TABLE_CACHE
    if c["path"] == path and c["mtime"] == mtime:
        return c["table"]
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return {}
    c.update(path=path, mtime=mtime, table=table)
    return table


def save_table(table: dict, path: str | None = None) -> None:
    """Write the table atomically (a temporary file, then one rename)."""
    path = path or _table_path()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    _TABLE_CACHE.update(
        path=path, mtime=os.stat(path).st_mtime_ns, table=table
    )


def lookup_entry(curve, n: int, table: dict | None = None,
                 device=None) -> dict:
    """The tuned entry for this device, curve and n ({} if untuned).

    Keys the engine consults (each optional):
      chunk: the window size (over choose_chunk_size);
      smvp: "tree" | "stream" (over the static tree/stream boundary);
      tree_finish: the hybrid finish level K (over K = 2).
    device None means the first CUDA device."""
    table = load_table() if table is None else table
    entry = table.get(device_key(resolve_device(device)), {})
    return entry.get(curve.name, {}).get(str(int(n)), {})


def lookup(curve, n: int, table: dict | None = None,
           device=None) -> int | None:
    """The tuned window size for this device, curve and n, or None."""
    return lookup_entry(curve, n, table, device).get("chunk")


def _entry(table: dict, device, curve, n: int) -> dict:
    return (table.setdefault(device_key(device), {})
            .setdefault(curve.name, {}).setdefault(str(int(n)), {}))


def _timed_runs(eng, case, chunk: int, runs: int, what: str) -> float:
    """The inputs staged on the engine's device once; one cold msm_device
    and _finalize, held against the case's expected point; then `runs`
    warm msm_device calls, each fenced.  Returns the best warm time."""
    from .testdata import staged_inputs

    points, scalars = staged_inputs(eng, case.point_words, case.scalar_words)
    result = eng._finalize(eng.msm_device(points, scalars, chunk), chunk)
    if (result["x"], result["y"]) != tuple(case.expected):
        raise AssertionError(
            f"{what} produced a WRONG result — disqualified"
        )
    best = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fence(eng.msm_device(points, scalars, chunk))
        best.append(time.perf_counter() - t0)
    return min(best)


@functools.lru_cache(maxsize=1)
def _bench_case(curve, n: int, device: str):
    """The bench case of (curve, n), made once for every candidate of a
    tuning run (the last one kept)."""
    from . import testdata

    return testdata.make_bench_case(curve, int(np.log2(n)),
                                    device=torch.device(device))


def _default_measure(engine_cls, curve, n, chunk, runs, device=None):
    """Window-size timing on the bench case (distinct points).

    autotune=False: an engine under measurement must not consult the
    table being written."""
    dev = resolve_device(device)
    eng = engine_cls(curve, chunk_size=chunk, autotune=False, device=dev)
    return _timed_runs(eng, _bench_case(curve, n, str(dev)), chunk, runs,
                       f"chunk {chunk} at n={n}")


def _disqualified(what: str, e: Exception) -> None:
    """A candidate that failed otherwise than by a wrong result (out of
    memory, a build or launch failure) is left out; its memory freed."""
    print(f"  {what}: disqualified ({type(e).__name__}: {e})")


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def autotune_chunk(
    curve,
    n: int,
    candidates=DEFAULT_CANDIDATES,
    runs: int = 2,
    measure_fn=None,
    persist: bool = True,
    device=None,
) -> int:
    """Measure the window-size candidates on the device; persist and
    return the winner.  measure_fn(engine_cls, curve, n, chunk, runs) ->
    seconds (default: the bench case on `device`, None meaning the first
    CUDA device).

    Every candidate's result is checked: a wrong one raises and stops the
    run, never recording a fast but broken configuration; any other
    failure disqualifies that candidate alone."""
    from ..models.cuzk import CuzkMsmEngine

    dev = resolve_device(device)
    measure_fn = measure_fn or functools.partial(_default_measure, device=dev)
    results = {}
    # a smaller window means more windows and a bigger footprint on the
    # device: the big candidates run last, so that an out-of-memory
    # failure disqualifies only itself (chunk 13 at 2^20: 20 windows x
    # 2^20 entries)
    for c in sorted(candidates, reverse=True):
        # from 2^16 only windows whose buckets fill whole 256-lane slabs
        if n >= 65536 and not stream_supported(c):
            continue
        try:
            results[c] = measure_fn(CuzkMsmEngine, curve, n, c, runs)
        except AssertionError:
            raise  # a WRONG result must crash the tuning run
        except Exception as e:
            _disqualified(f"chunk {c}", e)
        finally:
            _free()
    if not results:
        raise ValueError(f"no viable chunk candidates for n={n}")
    winner = min(results, key=results.get)
    if persist:
        table = load_table()
        entry = _entry(table, dev, curve, n)
        entry["chunk"] = winner
        entry["warm_s"] = {str(c): round(t, 4) for c, t in results.items()}
        save_table(table)
    return winner


#: SMVP-path candidates: (smvp_mode, tree_finish).  "tree" + K is the
#: hybrid (K pairwise levels, then the packed finish); "stream" is the
#: stream kernel.
SMVP_CANDIDATES = (("stream", None), ("tree", 1), ("tree", 2), ("tree", 3))


def _default_measure_smvp(curve, n, chunk, smvp, tree_finish, runs,
                          device=None):
    from ..models.cuzk import CuzkMsmEngine

    dev = resolve_device(device)
    eng = CuzkMsmEngine(
        curve, chunk_size=chunk, smvp_mode=smvp, tree_finish=tree_finish,
        autotune=False, device=dev,
    )
    return _timed_runs(
        eng, _bench_case(curve, n, str(dev)), chunk, runs,
        f"smvp {smvp}/K={tree_finish} at n={n}",
    )


def autotune_smvp(
    curve,
    n: int,
    chunk: int | None = None,
    candidates=SMVP_CANDIDATES,
    runs: int = 2,
    measure_fn=None,
    persist: bool = True,
    device=None,
):
    """Measure the SMVP-path candidates (stream against the hybrid tree at
    each finish level K) on the device; persist and return the winning
    (smvp_mode, tree_finish) pair.  measure_fn(curve, n, chunk, smvp,
    tree_finish, runs) -> seconds.

    The static boundary (the tree from 2^18) and K = 2 are the JAX
    package's TPU results; this measures them on this device.  Every
    result is checked, as in autotune_chunk."""
    dev = resolve_device(device)
    measure_fn = measure_fn or functools.partial(_default_measure_smvp,
                                                 device=dev)
    chunk = chunk or lookup(curve, n, device=dev) or choose_chunk_size(n)
    results = {}
    for smvp, k in candidates:
        if not stream_supported(chunk):
            continue  # both paths on the stream's window shapes
        try:
            results[(smvp, k)] = measure_fn(curve, n, chunk, smvp, k, runs)
        except AssertionError:
            raise  # a WRONG result must crash the tuning run
        except Exception as e:
            _disqualified(f"smvp {smvp}/K={k}", e)
        finally:
            _free()
    if not results:
        raise ValueError(
            f"no viable SMVP candidates for n={n}, chunk={chunk}"
        )
    winner = min(results, key=results.get)
    if persist:
        table = load_table()
        entry = _entry(table, dev, curve, n)
        entry["smvp"], entry["tree_finish"] = winner[0], winner[1]
        entry["smvp_warm_s"] = {
            f"{m}-K{k}": round(t, 4) for (m, k), t in results.items()
        }
        save_table(table)
    return winner


def main(argv: list[str] | None = None):
    from ..params import CurveId

    ap = argparse.ArgumentParser()
    ap.add_argument("--powers", type=int, nargs="+", default=[16, 20])
    ap.add_argument("--curve", default="bls12_377",
                    choices=["bls12_377", "edwards_bls12"])
    ap.add_argument("--candidates", type=int, nargs="+",
                    default=list(DEFAULT_CANDIDATES))
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--tune", default="all",
                    choices=["chunk", "smvp", "all"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain forms)")
    args = ap.parse_args(argv)
    curve = CurveId(args.curve)
    dev = resolve_device(args.device)
    for p in args.powers:
        if args.tune in ("chunk", "all"):
            w = autotune_chunk(
                curve, 1 << p, candidates=tuple(args.candidates),
                runs=args.runs, device=dev,
            )
            print(f"2^{p} {args.curve}: chunk {w} (table: {_table_path()})")
        if args.tune in ("smvp", "all"):
            m, k = autotune_smvp(curve, 1 << p, runs=args.runs, device=dev)
            print(f"2^{p} {args.curve}: smvp {m} tree_finish={k}")


if __name__ == "__main__":
    main()
