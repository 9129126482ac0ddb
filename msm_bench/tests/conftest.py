"""Tiny cells for the CPU: the benchmark's own cells with their traffic cut
to a few points, run through run.run_cell on the port's plain forms; a
cell's configuration or traffic may be swapped for another's file (the
Edwards field runs the plain forms several times faster than G1's; the
batch traffic is kept for a later cell)."""

import json

import pytest

from msm_bench import cell as C


def tiny_cell(workload: str, n: int = 64, sets: int | None = None,
              pool: int | None = None, config: str | None = None,
              traffic: str | None = None) -> C.Cell:
    cell = C.load(workload)
    if config:
        cell.config = json.loads((C.HERE / "configs" / f"{config}.json").read_text())
    if traffic:
        cell.traffic = json.loads((C.HERE / "traffic" / f"{traffic}.json").read_text())
    sets = sets or min(cell.sets_per_call, 2)
    cell.traffic = dict(cell.traffic, n=n, sets_per_call=sets,
                        pool_sets=pool or 2 * sets)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
