"""The port's multi-process entry (parallel/multihost.py), its dry run
(parallel/dryrun.py), and the multi-device harness on the CPU: the sweep's
scaling mode (harness/sweep.py run_scaling, --devices) and
bench_torch.py --sharded.

The dry run spawns two processes of two CPU shards each on gloo (a
file:// rendezvous in a temporary directory), and each prints OK after
its compute_msm and batch equal the oracle.  In this process: init's
argument rules, a one-process gloo group whose engine equals the oracle,
then destroy_process_group.  Exact equality throughout.
"""

import json
import random

import pytest
import torch
import torch.distributed as dist

import bench_torch
from webgpu_msm_bls12_377_tpu.harness import sweep as jsweep
from webgpu_msm_bls12_377_tpu_torch.harness import sweep
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.parallel import dryrun, multihost
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import G1, naive_msm

from test_torch_autotune import use_case_cache, write_bench_cases

torch.set_num_threads(1)

ED = CurveId.EDWARDS_BLS12
#: the sharded engine's options for the tiny cases: the hybrid tree
TREE = ("--smvp-mode", "tree", "--tree-finish", "2")


def test_two_process_gloo_dry_run(capfd):
    """Two processes, two CPU shards each: both print OK."""
    assert dryrun.run(timeout=240) == 0
    out = capfd.readouterr().out
    assert "OK rank 0" in out and "OK rank 1" in out


@pytest.mark.parametrize("kw,env,error", [
    ({}, {}, "MASTER_ADDR"),
    ({"init_method": "file:///nowhere", "local_devices": ["cpu"],
      "backend": "nccl"}, {}, "gloo, not nccl"),
    ({"init_method": "file:///nowhere"}, {}, "no CUDA device"),
    ({"init_method": "file:///nowhere"}, {"LOCAL_RANK": "0"},
     "no CUDA device"),
], ids=["no-rendezvous", "cpu-nccl", "no-gpu", "local-rank-no-gpu"])
def test_init_refuses(monkeypatch, kw, env, error):
    """Without a rendezvous init raises; CPU shards never take NCCL; with
    no CUDA device the default local devices (every local GPU, or
    cuda:LOCAL_RANK) raise: nothing falls back to the CPU."""
    for k in ("MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises((ValueError, RuntimeError), match=error):
        multihost.init(world_size=1, rank=0, **kw)
    assert not dist.is_initialized()


def test_one_process_group(tmp_path, monkeypatch):
    """init from torchrun-style RANK / WORLD_SIZE and a file://
    rendezvous, gloo for CPU shards, global_mesh over the group, and
    make_engine's result against the oracle; then the group is left."""
    with pytest.raises(RuntimeError, match="multihost.init"):
        multihost.global_mesh()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setattr(multihost, "_local_devices", None)
    multihost.init(init_method=f"file://{tmp_path / 'rendezvous'}",
                   local_devices=["cpu", "cpu"])
    try:
        assert dist.get_backend() == "gloo"
        eng = multihost.make_engine(chunk_size=4, num_bpr_threads=4,
                                    smvp_mode="tree", tree_finish=2,
                                    autotune=False)
        assert (eng.mesh.size, eng.mesh.world_size) == (2, 1)
        assert eng.mesh.group is not None
        rng = random.Random("multihost")
        pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 60))
               for _ in range(24)]
        scalars = [rng.randrange(0, 1 << 253) for _ in pts]
        got = eng.compute_msm([crv.g1_to_affine(p) for p in pts], scalars)
        assert (got["x"], got["y"]) == crv.g1_to_affine(
            naive_msm(pts, scalars, G1))
    finally:
        dist.destroy_process_group()


ROWS = [
    {"devices": 1, "power": 20, "mean_warm_s": 0.0312,
     "points_per_s": 33608205.1, "points_per_s_per_chip": 33608205.1,
     "efficiency": 1.0, "verified": True},
    {"devices": 2, "skipped": "not enough devices"},
]


def test_scaling_table_is_the_jax_text():
    assert sweep.markdown_table(ROWS) == jsweep.markdown_table(ROWS)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The Edwards 2^6 bench case, made with Python integers."""
    return write_bench_cases(tmp_path_factory.mktemp("scaling-cache"), (6,))


def test_run_scaling_on_cpu_shards(cache, monkeypatch, capsys, tmp_path):
    """The sweep's scaling mode at 2^6, --device cpu: one and two CPU
    shards, both verified against the golden, the efficiency against the
    first row; with no GPU, the CUDA rows are skipped."""
    monkeypatch.setenv("MSM_AUTOTUNE_DIR", str(tmp_path))
    use_case_cache(monkeypatch, cache)
    sweep.main(["--powers", "6", "--runs", "1", "--devices", "1", "2",
                "--device", "cpu", "--curve", "edwards_bls12", *TREE])
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in lines[:2]]
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["verified"] and r["path"] == "tree" for r in rows)
    assert rows[0]["efficiency"] == 1.0
    assert rows[1]["points_per_s_per_chip"] == round(
        rows[1]["points_per_s"] / 2, 1)
    assert lines[2].startswith("| devices |") and len(lines) == 6
    skipped = sweep.run_scaling(ED, 6, 1, [1])
    assert skipped == [{"devices": 1, "skipped": "not enough devices"}]


def test_bench_sharded_on_cpu_shards(cache, monkeypatch, capsys, tmp_path):
    """bench_torch.py --sharded --device cpu: the sharded engine over two
    CPU shards, the checked 2^6 golden, n_devices 2; with --batch it
    refuses, as bench.py does."""
    monkeypatch.setenv("MSM_AUTOTUNE_DIR", str(tmp_path))
    argv = ["--device", "cpu", "--n", "64", "--runs", "1", "--curve",
            "edwards_bls12", "--cache-dir", cache, "--sharded", *TREE]
    assert bench_torch.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["detail"]["n_devices"] == 2 and out["detail"]["checked"]
    assert out["detail"]["path"] == "tree"
    assert out["value"] == 64 / out["detail"]["mean_warm_s"]
    assert bench_torch.main(argv + ["--batch", "2"]) == 1
