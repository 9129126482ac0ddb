"""harness/sweep.py of the port on the CPU: the Markdown table is the JAX
package's text for the same rows; the same-point inputs are the JAX
package's words and expected point; run_power is verified on the bench
case (distinct points, held against the golden) and on the same-point
inputs; the CLI prints a JSON line a power, the table and the CSV.  The
cases' words are put in a cache directory first, made with Python
integers by the seed scheme (tests/test_torch_autotune.py's helpers)."""

import json

import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu.harness import sweep as jsweep
from webgpu_msm_bls12_377_tpu.params import CurveId as JCurveId
from webgpu_msm_bls12_377_tpu_torch.harness import sweep
from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine
from webgpu_msm_bls12_377_tpu_torch.params import CurveId

from test_torch_autotune import use_case_cache, write_bench_cases

torch.set_num_threads(1)

ED = CurveId.EDWARDS_BLS12
ROWS = [
    {"power": 16, "n": 65536, "cold_s": 0.512, "mean_warm_s": 0.0123,
     "points_per_s": 5328130.1, "verified": True},
    {"power": 20, "n": 1048576, "cold_s": 1.5, "mean_warm_s": 0.0456,
     "points_per_s": 22995087.7, "verified": False},
]


@pytest.fixture(autouse=True)
def table_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MSM_AUTOTUNE_DIR", str(tmp_path))


def test_markdown_table_is_the_jax_text():
    assert sweep.markdown_table(ROWS) == jsweep.markdown_table(ROWS)
    assert sweep.markdown_table([]) == jsweep.markdown_table([])


@pytest.mark.parametrize("curve", ["bls12_377", "edwards_bls12"],
                         ids=["", "ed"])
def test_same_point_inputs_are_the_jax_ones(curve):
    pw, sw, want = sweep._same_point_inputs(CurveId(curve), 1 << 6)
    jpw, jsw, jwant = jsweep._same_point_inputs(JCurveId(curve), 1 << 6)
    assert pw.dtype == jpw.dtype and np.array_equal(pw, jpw)
    assert sw.dtype == jsw.dtype and np.array_equal(sw, jsw)
    assert tuple(want) == tuple(jwant)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The Edwards 2^6 bench case, made with Python integers."""
    return write_bench_cases(tmp_path_factory.mktemp("sweep-cache"), (6,))


@pytest.fixture
def cached_cases(cache, monkeypatch):
    use_case_cache(monkeypatch, cache)


def test_run_power_verifies_the_bench_case(cached_cases):
    """The Edwards 2^6 bench case (pinned golden) through the default
    engine on the CPU: verified, with JAX's keys, the chunk and the path."""
    eng = CuzkMsmEngine(ED, num_bpr_threads=4, device="cpu")
    row = sweep.run_power(eng, ED, 6, 1)
    assert row["verified"] is True and row["distinct_points"] is True
    assert (row["power"], row["n"], row["chunk"], row["path"]) == (
        6, 64, 4, "fused")
    assert len(row["warm_s"]) == 1 and row["points_per_s"] > 0
    assert row["mean_with_cold_s"] >= min(row["cold_s"], row["mean_warm_s"])


def test_run_power_same_point_and_a_wrong_result(monkeypatch):
    """The same-point inputs at 2^6 (the legacy path at chunk 5) are
    verified; a wrong result is reported, not raised."""
    eng = CuzkMsmEngine(ED, chunk_size=5, num_bpr_threads=4, device="cpu")
    row = sweep.run_power(eng, ED, 6, 1, same_point=True)
    assert row["verified"] is True and row["distinct_points"] is False
    assert row["path"] == "legacy"
    monkeypatch.setattr(CuzkMsmEngine, "_finalize",
                        lambda self, coords, chunk: {"x": 0, "y": 1})
    assert sweep.run_power(eng, ED, 6, 1, same_point=True)[
        "verified"] is False


def test_cli_prints_rows_table_and_csv(cached_cases, tmp_path, capsys):
    out_csv = tmp_path / "sweep.csv"
    sweep.main(["--powers", "6", "--runs", "1", "--curve", "edwards_bls12",
                "--device", "cpu", "--chunk-size", "5", "--smvp-mode",
                "legacy", "--csv", str(out_csv)])
    lines = capsys.readouterr().out.strip().splitlines()
    row = json.loads(lines[0])
    assert row["verified"] is True and row["chunk"] == 5
    assert "\n".join(lines[1:]) == sweep.markdown_table([row])
    csv = out_csv.read_text().splitlines()
    assert csv[0] == "power,n,cold_s,mean_warm_s,points_per_s,verified"
    assert csv[1].startswith("6,64,") and csv[1].endswith(",True")
