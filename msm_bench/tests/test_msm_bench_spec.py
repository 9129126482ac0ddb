"""BENCHMARK.json against the benchmark contract's shape, and every file a
name in it leads to."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == KEYS["top"]
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    assert all(PATH.match(p) for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_entries(section):
    entries = SPEC[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), e[key]


def test_names_lead_to_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = set()
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        used.add(w["config"])
        traffic = json.loads((ROOT / "msm_bench" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (ROOT / "msm_bench" / "gen" / f"{traffic['kind']}.py").exists()
        assert (ROOT / "msm_bench" / "callers" / f"{traffic['caller']}.py").exists()
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "msm_bench" / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in SPEC["per_layer"])


def test_layer_maps_are_disjoint():
    from msm_bench import cell

    maps = cell.layer_maps()
    assert sum(m["kernels"] == "rest" for m in maps.values()) == 1
    named = [k for m in maps.values() if m["kernels"] != "rest"
             for k in m["kernels"]]
    assert len(set(named)) == len(named)
