"""The control: the reference in the program's place with one guarantee
broken.  It drops bit 252 of every scalar (a 252-bit scalar width, one
bit under the configurations' 253), the shortcut of a window fewer, and
must come out not correct in every cell.

    python3 msm_bench/control.py --workload <name> --seeds <n> ... [--seconds 5]

runs the cell's set-up and window with the control as its caller, at the
cell's own sizes, and prints each seed's compared numbers as JSON lines.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from msm_bench import cell as C  # noqa: E402
from msm_bench import reference, run  # noqa: E402

#: bit 252 cleared in the top word
MASK = 0x0FFFFFFF


class Caller:
    def __init__(self, bases, pool):
        self.bases = bases
        self.pool = []
        for words in pool:
            cut = words.copy()
            cut[:, 7] &= MASK
            self.pool.append(cut)

    def call(self, sets: list[int]) -> list[tuple[int, int]]:
        return [reference.msm(self.bases, self.pool[s]) for s in sets]


def wrap(caller, bases, pool) -> Caller:
    return Caller(bases, pool)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = C.load(args.workload)
    for seed in args.seeds:
        out = run.run_cell(cell, seed, args.seconds, False, wrap=wrap)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
