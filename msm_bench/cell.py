"""One cell of BENCHMARK.json and the files it names, found by name:
the configuration (its `file`), the traffic (traffic/<name>.json), the
traffic's generator (gen/<kind>.py) and caller (callers/<caller>.py), the
cell's metrics (metrics/<name>.py) and every layer map (layers/*.json).
Adding any of these is adding a file; no code here names one."""

from __future__ import annotations

import dataclasses
import importlib
import json
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def n(self) -> int:
        return self.traffic["n"]

    @property
    def sets_per_call(self) -> int:
        return self.traffic["sets_per_call"]

    def generator(self):
        return importlib.import_module(f"msm_bench.gen.{self.traffic['kind']}")

    def caller(self):
        return importlib.import_module(
            f"msm_bench.callers.{self.traffic['caller']}")


def load(workload: str) -> Cell:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(metrics, parent_names=None):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])
                and (parent_names is None or m["moves"] in parent_names)]

    e2e = mine(spec["end_to_end"])
    return Cell(workload, w["chips"], config, traffic, e2e,
                mine(spec["per_layer"], {m["name"] for m in e2e}))


def layer_maps() -> dict[str, dict]:
    """layers/<name>.json by name."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted((HERE / "layers").glob("*.json"))}


def metric_reader(name: str):
    return importlib.import_module(f"msm_bench.metrics.{name}").read


def rng(seed: int, *labels: str) -> np.random.Generator:
    """A generator for one purpose of one run: every whole seed, negative
    or past 64 bits too, gives its own stream."""
    entropy = abs(seed) * 2 + (seed < 0)
    key = tuple(zlib.crc32(label.encode()) for label in labels)
    return np.random.default_rng(np.random.SeedSequence(entropy, spawn_key=key))
