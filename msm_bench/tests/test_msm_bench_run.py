"""run.py end to end on the CPU at tiny sizes, with the port's plain
forms: the result line's keys, the control and the planted faults coming
out not correct, the look for a card, and the import guard."""

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from msm_bench import control, run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 77
BATCH = "batch8_2p20"  # kept for a later cell
TOP = ["correct", "attempted", "failed", "metrics", "device"]


def go(cell, traced=False, wrap=None):
    return run.run_cell(cell, SEED, 0.2, traced, device="cpu", wrap=wrap,
                        cache=None)


def test_sound_run_and_its_keys(tiny):
    cell = tiny("ed_2p18.zipf", traffic=BATCH)
    out = go(cell)
    assert list(out) == TOP + ["checks"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {"points_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["checks"] == {"wrong_msms": {"value": 0, "limit": 0}}
    json.dumps(out)


def test_traced_run_and_its_keys(tiny):
    cell = tiny("ed_2p18.zipf")
    out = go(cell, traced=True)
    assert list(out) == TOP + ["breakdown", "checks"]
    assert out["correct"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out["breakdown"].values())
    assert {"busy_s", "window_s"} <= set(out["device"])
    names = {m["name"] for m in cell.per_layer}
    assert set(out["metrics"]) <= names and "launches_per_msm" in out["metrics"]


def test_g1_single_entry(tiny):
    assert go(tiny("g1_2p18.zipf", n=32))["correct"]


def altered(caller, bases, pool):
    class Altered:
        def call(self, sets):
            res = caller.call(sets)
            x, y = res[-1]
            return res[:-1] + [(x ^ 1, y)]
    return Altered()


def half_sets(caller, bases, pool):
    class HalfSets:
        def call(self, sets):
            half = caller.call(sets[:len(sets) // 2])
            return half + half[:len(sets) - len(half)]
    return HalfSets()


def half_points(caller, bases, pool):
    n = bases.n // 2
    return type(caller)(caller_config(caller), bases.wire[:n].tobytes(),
                        [w[:n].tobytes() for w in pool], "cpu")


def caller_config(caller):
    if hasattr(caller, "engine"):
        return {"curve": caller.engine.curve.value}
    return {"entry": caller.fn.__name__}


@pytest.mark.parametrize("workload,traffic,wrap", [
    ("ed_2p18.zipf", BATCH, altered),
    ("ed_2p18.zipf", BATCH, half_sets),
    ("ed_2p18.zipf", BATCH, half_points),
    ("ed_2p18.zipf", None, altered),
    ("ed_2p18.zipf", None, half_points),
    ("ed_2p18.zipf", BATCH, control.wrap),
    ("g1_2p18.zipf", None, control.wrap),
])
def test_faults_and_control_are_not_correct(tiny, workload, traffic, wrap):
    out = go(tiny(workload, traffic=traffic), wrap=wrap)
    assert not out["correct"]
    assert out["checks"]["wrong_msms"]["value"] > out["checks"]["wrong_msms"]["limit"]
    assert out["failed"] == out["checks"]["wrong_msms"]["value"]


def test_a_failing_call_is_not_correct(tiny):
    def broken(caller, bases, pool):
        class Broken:
            calls = 0

            def call(self, sets):
                Broken.calls += 1
                if Broken.calls > 1:
                    raise RuntimeError("planted")
                return caller.call(sets)
        return Broken()
    out = go(tiny("ed_2p18.zipf"), wrap=broken)
    assert not out["correct"] and out["failed"] >= 1


def test_banned_module_means_no_result(tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert go(tiny("ed_2p18.zipf")) is None


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the look for one passes")
    proc = subprocess.run(
        [sys.executable, "msm_bench/run.py", "--workload", "ed_2p18.zipf",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


GUARD = """
import sys
sys.path.insert(0, {root!r})
{body}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "webgpu_msm_bls12_377_tpu",
                       "webgpu_msm_bls12_377_tpu_torch"}}))
"""


def guarded(body: str) -> list:
    proc = subprocess.run([sys.executable, "-c", GUARD.format(root=str(ROOT),
                                                             body=body)],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return eval(proc.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program():
    assert guarded("import msm_bench.reference, msm_bench.bases, "
                   "msm_bench.control, msm_bench.work") == []


def test_a_run_imports_no_jax():
    body = ("from msm_bench import run\n"
            "from msm_bench.tests.conftest import tiny_cell\n"
            "assert run.run_cell(tiny_cell('ed_2p18.zipf', n=16), 3, 0.1, True,"
            " device='cpu', cache=None)['correct']")
    assert guarded(body) == ["webgpu_msm_bls12_377_tpu_torch"]
