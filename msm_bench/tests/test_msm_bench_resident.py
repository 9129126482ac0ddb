"""The resident cell (g1_2p24.resident4: configs/bls12_377_g1_resident.json,
traffic/resident4_2p24.json, callers/resident.py) on the CPU at tiny
sizes, with the port's plain forms: read by cell.load, correct end to end
with its per-layer metrics in a traced run, the key taken once and never
sent again, and the control and a program that reads the caller's buffer
late coming out not correct."""

import numpy as np

from msm_bench import cell as C
from msm_bench import control, run
from msm_bench.callers import resident

SEED = 2**31 + 22
CELL = "g1_2p24.resident4"


def go(cell, traced=False, wrap=None):
    return run.run_cell(cell, SEED, 0.2, traced, device="cpu", wrap=wrap,
                        cache=None)


def test_the_cell_as_cell_load_reads_it():
    cell = C.load(CELL)
    assert cell.chips == 1
    assert (cell.n, cell.sets_per_call, cell.traffic["pool_sets"]) == (
        1 << 24, 4, 8)
    assert cell.config["name"] == "bls12_377_g1_resident"
    assert cell.config["entry"] == "multi_scalar_mult_init"
    assert cell.config["n"] == cell.n and cell.config["batch_size"] == 4
    assert set(cell.config["reduced"]) == {"n"}
    assert cell.caller() is resident
    assert cell.generator().__name__.endswith("gen.uniform")
    assert {m["name"] for m in cell.end_to_end} == {"points_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"set_host_ms_per_msm",
                                                   "key_gib"}
    assert CELL not in {w for m in C.load("g1_2p18.zipf").per_layer
                        for w in m.get("workloads", [])}


def test_tiny_cell_is_correct_and_reads_its_metrics(tiny):
    cell = tiny(CELL, n=16)
    out = go(cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {"points_per_s", "setup_s"}
    traced = go(cell, traced=True)
    assert traced["correct"]
    assert set(traced["metrics"]) == {"set_host_ms_per_msm", "key_gib"}
    # the table of 16 points on the path their n takes (its size alone
    # counts: the points may be any words)
    key = resident.multi_scalar_mult_init(bytes(16 * 96), device="cpu")
    assert traced["metrics"]["key_gib"]["value"] == key.key_bytes / 2**30
    assert traced["metrics"]["set_host_ms_per_msm"]["value"] > 0


def test_the_key_is_taken_once_and_never_sent_again(tiny, monkeypatch):
    """One init over the whole run; every call hands over the handle and
    its sets' scalar bytes alone."""
    inits, calls = [], []
    real_init, real_call = resident.multi_scalar_mult_init, resident.multi_scalar_mult

    def init(points, **kw):
        inits.append(len(points))
        return real_init(points, **kw)

    def call(bases, sets):
        calls.append([len(s) for s in sets])
        return real_call(bases, sets)

    monkeypatch.setattr(resident, "multi_scalar_mult_init", init)
    monkeypatch.setattr(resident, "multi_scalar_mult", call)
    cell = tiny(CELL, n=16)
    assert go(cell)["correct"]
    assert inits == [16 * 96]
    assert len(calls) >= 2 and all(c == [16 * 32] * 2 for c in calls)


def reads_the_buffer_late(caller, bases, pool):
    """A program that keeps the caller's buffer, not a copy, and reads it
    at each call, after the caller has zeroed it."""
    from webgpu_msm_bls12_377_tpu_torch.models import CuzkMsmEngine

    buf = bytearray(bases.wire.tobytes())
    np.frombuffer(buf, dtype=np.uint8).fill(0)

    class Late:
        def call(self, sets):
            eng = CuzkMsmEngine(device="cpu")
            out = eng.compute_msm_batch(bytes(buf),
                                        [pool[s].tobytes() for s in sets])
            return [(r["x"], r["y"]) for r in out]
    return Late()


def test_control_and_a_late_read_are_not_correct(tiny):
    for wrap in (control.wrap, reads_the_buffer_late):
        out = go(tiny(CELL, n=16), wrap=wrap)
        assert not out["correct"]
        assert out["checks"]["wrong_msms"]["value"] > 0
