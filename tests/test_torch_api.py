"""The port's public surface against the JAX package's, on the CPU: the
wire packers (C-contiguous, word for word the JAX packers' values), the
entry points' keywords (log_result, force_recompile) on both curves, the
exported names, and the package docstring.  Exact equality throughout.
"""

import random
from pathlib import Path

import numpy as np
import pytest
import torch

import webgpu_msm_bls12_377_tpu as jpkg
import webgpu_msm_bls12_377_tpu_torch as port
from webgpu_msm_bls12_377_tpu.ops import convert as jconvert
from webgpu_msm_bls12_377_tpu_torch.ops import convert
from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import EDWARDS, G1, naive_msm

torch.set_num_threads(1)

CURVES = pytest.mark.parametrize("curve", ["bls12_377", "edwards_bls12"],
                                 ids=["", "ed"])


@pytest.mark.parametrize("coord_bytes", [48, 32])
def test_wire_packers_are_c_contiguous_and_match_jax(coord_bytes):
    """Points and scalars from bytes and from ints: C-contiguous uint32
    arrays (the engine's host-to-device copy reads them in one pass), the
    same words as the JAX packers'."""
    rng = random.Random(f"wire{coord_bytes}")
    n = 37
    pbuf = bytes(rng.randrange(256) for _ in range(2 * coord_bytes * n))
    sbuf = bytes(rng.randrange(256) for _ in range(32 * n))
    vals = [rng.randrange(1 << (8 * coord_bytes)) for _ in range(n)]
    pairs = [
        (convert.points_buffer_to_words(pbuf, coord_bytes),
         jconvert.points_buffer_to_words(pbuf, coord_bytes)),
        (convert.scalars_buffer_to_words(sbuf),
         jconvert.scalars_buffer_to_words(sbuf)),
        (convert.ints_to_words(vals, coord_bytes // 4),
         jconvert.ints_to_words(vals, coord_bytes // 4)),
    ]
    for got, want in pairs:
        assert got.flags.c_contiguous and got.dtype == np.uint32
        assert np.array_equal(got, want)


def msm_case(curve, n=8):
    rng = random.Random(f"api-{curve}")
    if curve == "bls12_377":
        pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 40))
               for _ in range(n)]
        aff = [crv.g1_to_affine(p) for p in pts]
        scalars = [rng.randrange(1 << 253) for _ in range(n)]
        want = crv.g1_to_affine(naive_msm(pts, scalars, G1))
        return port.compute_msm, aff, scalars, want
    pts = [crv.ed_scalar_mult(crv.ED_GENERATOR, rng.randrange(1, 1 << 40))
           for _ in range(n)]
    aff = [crv.ed_to_affine(p) for p in pts]
    scalars = [rng.randrange(1 << 253) for _ in range(n)]
    want = crv.ed_to_affine(naive_msm(pts, scalars, EDWARDS))
    return port.compute_msm_edwards, aff, scalars, want


@CURVES
def test_entry_points_take_the_reference_keywords(curve, capsys, tmp_path,
                                                  monkeypatch):
    """log_result prints the result, as the JAX api does; force_recompile
    on a CPU call compiles nothing and leaves the built libraries, and
    the ones loaded, as they are; the result is the oracle's."""
    fn, aff, scalars, want = msm_case(curve)
    monkeypatch.setattr(K, "BUILD_ROOT", tmp_path)
    built = K._build_dir()
    built.mkdir(parents=True)
    (built / "libmsm_tree.so").write_bytes(b"built")
    loaded = {"tree": object()}
    monkeypatch.setattr(K, "_libs", dict(loaded))
    monkeypatch.setattr(K, "rebuild", lambda: pytest.fail("CPU call rebuilt"))
    got = fn(aff, scalars, log_result=True, force_recompile=True, device="cpu")
    assert (got["x"], got["y"]) == want
    assert capsys.readouterr().out.strip() == str(got)
    assert (built / "libmsm_tree.so").read_bytes() == b"built"
    assert K._libs == loaded
    assert fn(aff, scalars, device="cpu") == got
    assert capsys.readouterr().out == ""


@CURVES
def test_engine_takes_force_recompile(curve, monkeypatch):
    """CuzkMsmEngine(..., force_recompile=True), as the JAX constructor
    takes it: on the CPU it compiles nothing and the engine answers as
    before; on a CUDA device (resolve_device stubbed, no card here) it
    rebuilds every library once, at construction; the Pippenger engine
    passes the keyword on."""
    from webgpu_msm_bls12_377_tpu_torch.models import (
        CuzkMsmEngine,
        PippengerMsmEngine,
        cuzk,
    )
    from webgpu_msm_bls12_377_tpu_torch.params import CurveId

    cid = CurveId(curve)
    _, aff, scalars, want = msm_case(curve)
    rebuilt = []
    monkeypatch.setattr(K, "rebuild", lambda: rebuilt.append(1))
    for cls in (CuzkMsmEngine, PippengerMsmEngine):
        got = cls(cid, chunk_size=4, num_bpr_threads=4, force_recompile=True,
                  device="cpu").compute_msm(aff, scalars)
        assert (got["x"], got["y"]) == want
    assert rebuilt == []
    monkeypatch.setattr(cuzk, "resolve_device",
                        lambda device: torch.device("cuda"))
    CuzkMsmEngine(cid, force_recompile=True)
    assert rebuilt == [1]
    PippengerMsmEngine(cid, force_recompile=True)
    CuzkMsmEngine(cid)
    assert rebuilt == [1, 1]


def test_rebuild_replaces_each_library_in_place(tmp_path, monkeypatch):
    """kernels.rebuild (force_recompile on the card) compiles every library
    into a fresh directory and renames each over its old build: the build
    directory never goes away, every library is new, nothing of the
    fresh directory stays, and the loaded libraries are forgotten.  A
    stand-in compiler answers --version (the build key's toolkit id) and
    writes the source's name to the output."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    "if [ \"$1\" = --version ]; then echo stand-in; exit 0; fi\n"
                    "out=\nsrc=\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then out=$2; shift; else src=$1; fi\n"
                    "  shift\ndone\necho \"$src\" > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(K, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(K, "BUILD_ROOT", tmp_path / "kernels")
    built, _ = K.build_all()
    stale = built / "libmsm_tree.so"
    stale.write_text("stale")
    seen = []
    real_replace = K.os.replace

    def replace(src, dst):
        assert built.is_dir()  # a concurrent loader always finds the directory
        seen.append(Path(dst).name)
        real_replace(src, dst)

    monkeypatch.setattr(K.os, "replace", replace)
    monkeypatch.setattr(K, "_libs", {"tree": object()})
    out_dir, _ = K.rebuild()
    assert out_dir == built and K._libs == {}
    names = {f"libmsm_{name}.so" for name, _, _ in K.LIBRARIES}
    assert names <= set(seen)
    for name, source, _ in K.LIBRARIES:
        lib = built / f"libmsm_{name}.so"
        assert lib.read_text().strip() == str(K.CSRC / f"{source}.cu")
    assert sorted(p.name for p in (tmp_path / "kernels").iterdir()) == [built.name]


#: the port's own exports, which the reference has no counterpart of
PORT_ONLY = {"multi_scalar_mult_init", "multi_scalar_mult"}


def test_exports_match_the_reference_where_the_meaning_is_the_same():
    """The field moduli under the reference's names; MontParams and
    compute_misc_params describe the reference's w-bit limbs and are left
    out (the package docstring says why); the resident-bases entries are
    the port's alone, and the docstring names them."""
    assert port.BLS12_377_BASE_FIELD == jpkg.BLS12_377_BASE_FIELD
    assert port.EDWARDS_BLS12_BASE_FIELD == jpkg.EDWARDS_BLS12_BASE_FIELD
    assert set(port.__all__) - PORT_ONLY == set(jpkg.__all__) - {
        "MontParams", "compute_misc_params"}
    assert PORT_ONLY <= set(port.__all__)
    assert not PORT_ONLY & set(jpkg.__all__)
    assert all(hasattr(port, name) for name in port.__all__)
    assert "MontParams" in port.__doc__ and "compute_misc_params" in port.__doc__
    assert all(name in port.__doc__ for name in PORT_ONLY)


def test_package_docstring_names_every_path_for_both_curves():
    doc = " ".join(port.__doc__.split())
    assert "Twisted Edwards BLS12: on either curve" in doc
    for word in ("tree", "stream", "fused", "legacy", "batch", "Pippenger",
                 "naive", "multi_scalar_mult_init"):
        assert word in doc
    assert "device across calls" in doc
    assert "the tree and stream paths and batch mode" not in doc
