"""Port engine end to end (CPU, plain PyTorch versions of every kernel).

compute_msm on the hybrid tree (smvp_mode="tree" with tree_finish = K) at
the JAX package's small test shapes (tests/test_smvp_tree.py: N = 96,
chunk 4, 4 BPR threads) equals the
bigint oracle, for K = 1 and 2 and a duplicate-heavy scalar set; a slow
test holds it against the JAX engine in tree-interpret mode.  Guards: the
port imports no JAX and nothing of the JAX package, the public entry point
refuses to run without a GPU unless it is given device="cpu", and the
kernel wrappers refuse devices they have no kernel for.
"""

import os
import pathlib
import random
import re
import subprocess
import sys

import pytest
import torch

import webgpu_msm_bls12_377_tpu_torch as port
from webgpu_msm_bls12_377_tpu_torch.models import NaiveMsmEngine, PippengerMsmEngine
from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine
from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import EDWARDS, G1, naive_msm

# tiny tensors: one intra-op thread avoids oversubscribing the CPU
# beside the other test workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "webgpu_msm_bls12_377_tpu_torch"
CHUNK = 4
N = 96


@pytest.fixture(scope="module")
def case():
    rng = random.Random("tree-smvp")
    pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 60))
           for _ in range(N)]
    scalars = [rng.randrange(0, 1 << 253) for _ in range(N)]
    return pts, [crv.g1_to_affine(p) for p in pts], scalars


def engine(**kw):
    opts = dict(chunk_size=CHUNK, num_bpr_threads=4,
                smvp_mode="tree", tree_finish=2, device="cpu")
    opts.update(kw)
    return CuzkMsmEngine(**opts)


@pytest.mark.parametrize("k_finish", [1, 2])
def test_hybrid_engine_matches_oracle(case, k_finish):
    pts, aff, scalars = case
    got = engine(tree_finish=k_finish).compute_msm(aff, scalars)
    assert (got["x"], got["y"]) == crv.g1_to_affine(naive_msm(pts, scalars, G1))


def test_hybrid_engine_duplicate_heavy(case):
    """Every scalar equal: one bucket per window holds all N entries."""
    pts, aff, _ = case
    scalars = [0x1234_5678_9ABC_DEF0] * N
    got = engine(tree_finish=1).compute_msm(aff, scalars)
    assert (got["x"], got["y"]) == crv.g1_to_affine(naive_msm(pts, scalars, G1))


@pytest.mark.parametrize("curve", ["bls12_377", "edwards_bls12"],
                         ids=["", "ed"])
def test_hybrid_engine_cuts_a_long_bucket_into_pieces(curve):
    """300 points share one scalar beside 20 random ones: after two tree
    levels that scalar's bucket holds 75 nodes a window, more than PIECE,
    so the finish cuts it into pieces and folds them; the MSM is exact."""
    from webgpu_msm_bls12_377_tpu_torch.ops.smvp_stream import PIECE

    rng = random.Random("long-bucket" + curve)
    n, shared = 320, (1 << 252) + 0x0F1E2D3C4B5A6978
    scalars = [shared] * 300 + [rng.randrange(0, 1 << 253) for _ in range(20)]
    assert 300 // 4 > PIECE
    if curve == "bls12_377":
        pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 60))
               for _ in range(n)]
        aff, want = ([crv.g1_to_affine(p) for p in pts],
                     crv.g1_to_affine(naive_msm(pts, scalars, G1)))
    else:
        pts = [crv.ed_scalar_mult(crv.ED_GENERATOR, rng.randrange(1, 1 << 60))
               for _ in range(n)]
        aff, want = ([crv.ed_to_affine(p) for p in pts],
                     crv.ed_to_affine(naive_msm(pts, scalars, EDWARDS)))
    got = engine(curve=CurveId(curve)).compute_msm(aff, scalars)
    assert (got["x"], got["y"]) == want


def test_wire_buffers_equal_int_inputs(case):
    """bytes buffers (48-byte LE coords, 32-byte LE scalars) and word
    arrays give the same result as Python ints."""
    _, aff, scalars = case
    aff, scalars = aff[:24], scalars[:24]
    pbuf = b"".join(x.to_bytes(48, "little") + y.to_bytes(48, "little")
                    for x, y in aff)
    sbuf = b"".join(s.to_bytes(32, "little") for s in scalars)
    eng = engine()
    want = eng.compute_msm(aff, scalars)
    assert eng.compute_msm(pbuf, sbuf) == want
    assert eng.compute_msm(pbuf, list(scalars)) == want


def test_input_validation():
    eng = engine()
    with pytest.raises(ValueError, match="2\\^253"):
        eng.compute_msm([(1, 2)], [1 << 253])
    with pytest.raises(ValueError, match="mismatch"):
        eng.compute_msm([(1, 2)], [1, 2])
    # "fused" is a mode like the others; the JAX package's interpret modes
    # are not
    assert engine(smvp_mode="fused")._select_smvp(CHUNK, 4) == "fused"
    with pytest.raises(ValueError, match="unknown smvp_mode"):
        engine(smvp_mode="tree-interpret")
    with pytest.raises(ValueError, match="tree_finish"):
        engine(tree_finish=0)
    # Edwards takes every path too: its fused and legacy paths, "auto"
    # below chunk 9 (the fused path at chunk 4 and 8) and the baseline
    # engines, each with the curve's group (tests/test_torch_edwards_canon.py
    # runs them)
    ed = CurveId.EDWARDS_BLS12
    for mode in ("fused", "legacy"):
        eng = CuzkMsmEngine(ed, smvp_mode=mode, device="cpu")
        assert eng._select_smvp(8, 1 << 15) == mode and eng.group is C.EDWARDS
    assert PippengerMsmEngine(ed, device="cpu")._select_smvp(8, 1 << 15) == "legacy"
    assert NaiveMsmEngine(ed, device="cpu").group is C.EDWARDS
    assert CuzkMsmEngine(ed, device="cpu")._select_smvp(8, 1 << 15) == "fused"
    with pytest.raises(ValueError, match="power of two"):
        engine(num_bpr_threads=6)


def test_default_options_answer_below_2_18(case):
    """smvp_mode="auto" with the default chunk policy raises for no valid
    input: a small n takes chunk 4 and the fused path."""
    pts, aff, scalars = case
    eng = CuzkMsmEngine(device="cpu")
    assert eng._select_smvp(eng._chunk_for(8), 8) == "fused"
    got = port.compute_msm(aff[:8], scalars[:8], device="cpu")
    assert (got["x"], got["y"]) == crv.g1_to_affine(
        naive_msm(pts[:8], scalars[:8], G1))


def test_default_device_needs_a_gpu(case):
    """device=None means CUDA: without a GPU it raises, never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, aff, scalars = case
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.compute_msm(aff[:4], scalars[:4])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CuzkMsmEngine()


def test_wrappers_refuse_other_devices():
    """CPU tensors take the plain version (no launch is counted); a device
    the kernels do not serve raises."""
    K.reset_launches()
    a = torch.zeros((39, 8), dtype=torch.int32)
    K.bpr_stage2(a, a, 8, 1)
    K.mont_mul_const(torch.zeros((13, 8), dtype=torch.int32), 1)
    assert sum(K.launches.values()) == 0
    with pytest.raises(ValueError, match="no kernel for device"):
        K.bpr_stage2(a.to("meta"), a.to("meta"), 8, 1)
    with pytest.raises(ValueError, match="plane"):
        K.bpr_add(a, a[:, :4])


def test_empty_launch_is_neither_made_nor_counted():
    """An entry point with no threads to run is not called (so nothing is
    built or loaded here, where there is no nvcc) and not counted."""
    K.reset_launches()
    K.launch("bpr", "msm_bpr_add", "bpr_add", 0)
    assert sum(K.launches.values()) == 0
    assert not K._libs


def test_port_imports_no_jax_in_a_fresh_process():
    """Import every module of the port, the parallel package's by name too,
    and run a tiny MSM on one device and on two CPU shards, in a process
    where jax and the JAX package cannot be imported."""
    code = f"""
import sys, pkgutil, importlib, random
sys.modules["jax"] = None
sys.modules["webgpu_msm_bls12_377_tpu"] = None
sys.path.insert(0, {str(ROOT)!r})
import webgpu_msm_bls12_377_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from webgpu_msm_bls12_377_tpu_torch.harness import autotune, microbench, sweep
from webgpu_msm_bls12_377_tpu_torch.parallel import dryrun, mesh, multihost
from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, k) for k in range(1, 9)]
aff = [crv.g1_to_affine(p) for p in pts]
eng = CuzkMsmEngine(chunk_size=4, num_bpr_threads=4, smvp_mode="tree",
                    tree_finish=2, device="cpu")
got = eng.compute_msm(aff, list(range(1, 9)))
want = crv.g1_to_affine(crv.g1_scalar_mult(crv.G1_GENERATOR, 204))
assert (got["x"], got["y"]) == want, got
eng = mesh.ShardedMsmEngine(mesh=mesh.make_mesh(["cpu"] * 2), chunk_size=4,
                            num_bpr_threads=4, smvp_mode="tree", tree_finish=2)
got = eng.compute_msm(aff, list(range(1, 9)))
assert (got["x"], got["y"]) == want, got
assert not any(k == "jax" or k.startswith("jax.") or
               k.startswith("webgpu_msm_bls12_377_tpu.")
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_refuses_nothing_for_edwards():
    """The port raises NotImplementedError nowhere: every call, the device
    pool and the sharded engine included, answers on both curves."""
    raises = [f.name for f in PKG.rglob("*.py")
              for line in f.read_text().splitlines()
              if "NotImplementedError" in line]
    assert raises == []


def test_port_sources_name_no_jax():
    """No import of jax or the JAX package in the port (its harness and
    parallel modules among them), chip_smoke.py, bench_torch.py or
    tools/row_times.py."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|webgpu_msm_bls12_377_tpu)\b")
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                       ROOT / "bench_torch.py",
                                       ROOT / "tools" / "row_times.py"]
    assert {PKG / "harness" / f"{m}.py"
            for m in ("autotune", "microbench", "sweep")} <= set(files)
    assert {PKG / "parallel" / f"{m}.py"
            for m in ("mesh", "multihost", "dryrun")} <= set(files)
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert not bad


@pytest.mark.slow
@pytest.mark.parametrize("k_finish", [1, 2])
def test_matches_jax_engine_tree_interpret(case, k_finish):
    """The JAX engine (Pallas tree kernels in interpret mode) and the port
    give the same MSM on the same inputs."""
    from webgpu_msm_bls12_377_tpu.models.cuzk import CuzkMsmEngine as JEngine
    from webgpu_msm_bls12_377_tpu.params import CurveId as JCurveId

    _, aff, scalars = case
    jeng = JEngine(JCurveId.BLS12_377, chunk_size=CHUNK,
                   smvp_mode="tree-interpret", tree_finish=k_finish,
                   stream_lanes=8, num_bpr_threads=4)
    assert engine(tree_finish=k_finish).compute_msm(aff, scalars) == \
        jeng.compute_msm(aff, scalars)
