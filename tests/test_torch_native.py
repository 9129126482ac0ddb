"""The port's native C++ oracle (webgpu_msm_bls12_377_tpu_torch/native/)
against the JAX package's and against the Python integer MSM, both curves:
its header's constants equal the JAX generator's; it sums 12 points with
k = 0 and k = 1 among the scalars, all-zero scalars (G1: (0, 1)) and 2^12
points (i + 1) * G (held against the known-k identity) as both do; it
sums the 2^6 bench cases' wire bytes to their expected value; it refuses a
coordinate equal to p; $MSM_BUILD_DIR moves its build, which writes nothing
under the package's sources; two processes building into one empty root
both load a whole library; with g++ hidden it reports itself absent and
make_bench_case leaves oracle_checked False.  Exact equality throughout.
The bench cases' points are made here with Python integers (the port's
reference curve), in place of kernel 7's plain form, which is slow on the
CPU; tests/test_torch_harness.py holds those against the device path.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from webgpu_msm_bls12_377_tpu import native as jnative
from webgpu_msm_bls12_377_tpu.native import gen_params as jgen
from webgpu_msm_bls12_377_tpu.reference import curve as jcrv
from webgpu_msm_bls12_377_tpu.reference.msm import EDWARDS as JEDWARDS
from webgpu_msm_bls12_377_tpu.reference.msm import G1 as JG1
from webgpu_msm_bls12_377_tpu.reference.msm import naive_msm
from webgpu_msm_bls12_377_tpu_torch import native
from webgpu_msm_bls12_377_tpu_torch.harness import testdata as TD
from webgpu_msm_bls12_377_tpu_torch.native import gen_params
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "webgpu_msm_bls12_377_tpu_torch"
G1, ED = CurveId.BLS12_377, CurveId.EDWARDS_BLS12
CURVES = pytest.mark.parametrize("curve", [G1, ED], ids=["", "ed"])
HAS_GPP = shutil.which("g++") is not None
needs_gpp = pytest.mark.skipif(not HAS_GPP, reason="g++ not available")

#: per curve: the JAX reference's generator, scalar multiplication, affine
#: map and group, the port's oracle on ints, the JAX one's
JAX = {
    G1: (jcrv.G1_GENERATOR, jcrv.g1_scalar_mult, jcrv.g1_to_affine, JG1),
    ED: (jcrv.ED_GENERATOR, jcrv.ed_scalar_mult, jcrv.ed_to_affine, JEDWARDS),
}
ORACLES = {G1: (native.msm_g1_ints, jnative.msm_g1_ints),
           ED: (native.msm_edwards_ints, jnative.msm_edwards_ints)}


def parse_header(text: str) -> dict:
    """{name: value or limbs} of the header's constants (comments left
    out)."""
    out = {}
    for name, body in re.findall(r"static const \w+ (\w+)\[\d+\] = \{([^}]*)\}",
                                 text):
        out[name] = [int(v.strip().rstrip("ULL"), 16) for v in body.split(",")]
    for name, v in re.findall(r"static const \w+ (\w+) = (0x[0-9a-f]+|\d+)",
                              text):
        out[name] = int(v, 0)
    return out


def test_header_constants_equal_the_jax_generator(tmp_path):
    want = parse_header(Path(jgen.generate(str(tmp_path / "jax.h"))).read_text())
    path = gen_params.generate(tmp_path)
    got = parse_header(path.read_text())
    assert path == tmp_path / gen_params.HEADER
    assert got == want
    assert set(got) == {"NLIMBS", "ED_D_MONT", *(f"{f}_{c}" for f in ("BLS", "ED")
                                                 for c in ("P", "R2", "ONE", "N0"))}
    assert got["BLS_N0"] * got["BLS_P"][0] % (1 << 64) == (1 << 64) - 1


def jax_points(curve, n, rng):
    gen, mult, to_aff, _ = JAX[curve]
    pts = [mult(gen, rng.randrange(1, 1 << 64)) for _ in range(n)]
    return pts, [to_aff(p) for p in pts]


@needs_gpp
@CURVES
@pytest.mark.parametrize("kind", ["random", "zero"])
def test_oracle_equals_the_jax_oracle_and_naive_msm(curve, kind, rng):
    """n = 12 with k = 0 and k = 1 among the scalars, and all scalars 0."""
    pts, aff = jax_points(curve, 12, rng)
    ks = [rng.randrange(0, 1 << 253) for _ in range(12)]
    ks[3], ks[7] = 0, 1
    if kind == "zero":
        ks = [0] * 12
    port, jax = ORACLES[curve]
    got = port(aff, ks)
    assert got == jax(aff, ks)
    assert got == JAX[curve][2](naive_msm(pts, ks, JAX[curve][3]))
    if kind == "zero":
        assert got == (0, 1)


def successive_points(curve, n):
    """Affine (i + 1) * G for i < n, by successive affine additions of G in
    Python integers."""
    if curve == G1:
        p, gen = crv.P, crv.g1_to_affine(crv.G1_GENERATOR)

        def add(a, b):
            if a == b:
                lam = 3 * a[0] * a[0] * pow(2 * a[1], -1, p)
            else:
                lam = (b[1] - a[1]) * pow(b[0] - a[0], -1, p)
            x = (lam * lam - a[0] - b[0]) % p
            return x, (lam * (a[0] - x) - a[1]) % p
    else:
        p, gen = crv.Q, crv.ed_to_affine(crv.ED_GENERATOR)
        d = 3021

        def add(a, b):  # a = -1
            t = d * a[0] * b[0] * a[1] * b[1]
            return ((a[0] * b[1] + a[1] * b[0]) * pow(1 + t, -1, p) % p,
                    (a[1] * b[1] + a[0] * b[0]) * pow(1 - t, -1, p) % p)
    out = [gen]
    while len(out) < n:
        out.append(add(out[-1], gen))
    return out


@needs_gpp
@CURVES
def test_oracle_equals_the_known_k_identity_at_2_12(curve, rng):
    """2^12 points (i + 1) * G (the oracle's threaded windows): the sum is
    (sum of s_i (i + 1) mod r) * G; the JAX oracle agrees."""
    n = 1 << 12
    aff = successive_points(curve, n)
    ks = [rng.randrange(0, 1 << 253) for _ in range(n)]
    gen, mult, to_aff, _ = JAX[curve]
    total = sum(s * (i + 1) for i, s in enumerate(ks)) % TD.curve_order(curve)
    want = to_aff(mult(gen, total))
    port, jax = ORACLES[curve]
    assert port(aff, ks) == want == jax(aff, ks)


def host_points_from_ks(curve, k_words, device=None):
    """TD.points_from_ks with Python integers: (2, 12|8, n) uint32 words of
    the affine points k_i * G."""
    if CurveId(curve) == G1:
        mult, gen, to_aff, cw = (crv.g1_scalar_mult, crv.G1_GENERATOR,
                                 crv.g1_to_affine, 12)
    else:
        mult, gen, to_aff, cw = (crv.ed_scalar_mult, crv.ED_GENERATOR,
                                 crv.ed_to_affine, 8)
    aff = [to_aff(mult(gen, k)) for k in TD.words_to_ints(k_words)]
    return np.array([[[(pt[c] >> (32 * i)) & 0xFFFFFFFF for pt in aff]
                      for i in range(cw)] for c in (0, 1)], dtype=np.uint32)


@pytest.fixture
def host_points(monkeypatch):
    monkeypatch.setattr(TD, "points_from_ks", host_points_from_ks)


@needs_gpp
@CURVES
def test_wire_bytes_of_the_2_6_bench_cases(curve, host_points):
    """TD.to_wire of the 2^6 bench case sums to its expected value (G1:
    the pinned golden)."""
    case = TD.make_bench_case(curve, 6, cross_check=False)
    fn = native.msm_g1 if curve == G1 else native.msm_edwards
    assert fn(*TD.to_wire(case.point_words, case.scalar_words)) == case.expected
    assert case.golden_pinned == (curve == G1)


@needs_gpp
@CURVES
def test_coordinate_equal_to_p_raises(curve):
    p = crv.P if curve == G1 else crv.Q
    port, _ = ORACLES[curve]
    aff = successive_points(curve, 2)
    assert port(aff, [1, 1]) == successive_points(curve, 3)[2]
    for bad in ([(p, aff[0][1]), aff[1]], [aff[0], (aff[1][0], p)]):
        with pytest.raises(ValueError, match="not below p"):
            port(bad, [1, 2])
    with pytest.raises(ValueError, match="scalar bytes"):
        native.msm_g1(b"\0" * 96, b"\0" * 31)


def source_files():
    return {p: p.stat().st_mtime_ns for p in PKG.rglob("*")
            if "__pycache__" not in p.parts}


@needs_gpp
def test_build_dir_moves_the_build_and_writes_no_source(tmp_path, monkeypatch):
    before = source_files()
    monkeypatch.setenv("MSM_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    out = native.build_dir()
    assert out.parent == tmp_path / "b" / "native"
    assert sorted(f.name for f in out.iterdir()) == sorted(
        [gen_params.HEADER, native.LIBRARY])
    assert (out / gen_params.HEADER).read_text() == gen_params.header()
    assert native.msm_g1_ints(successive_points(G1, 3), [0, 0, 5]) == (
        crv.g1_to_affine(crv.g1_scalar_mult(crv.G1_GENERATOR, 15)))
    assert source_files() == before


@needs_gpp
def test_two_processes_build_into_one_empty_root(tmp_path):
    code = """
import sys
sys.path.insert(0, sys.argv[1])
from webgpu_msm_bls12_377_tpu_torch import native
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
g = crv.g1_to_affine(crv.G1_GENERATOR)
assert "torch" not in sys.modules
print(native.msm_g1_ints([g, g], [2, 3]) ==
      crv.g1_to_affine(crv.g1_scalar_mult(crv.G1_GENERATOR, 5)))
"""
    env = dict(os.environ, MSM_BUILD_DIR=str(tmp_path / "root"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(ROOT)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        assert out.strip() == "True"
    (out_dir,) = (tmp_path / "root" / "native").iterdir()
    assert sorted(f.name for f in out_dir.iterdir()) == sorted(
        [gen_params.HEADER, native.LIBRARY])


def test_without_gpp_the_oracle_is_absent(tmp_path, monkeypatch, host_points):
    """g++ hidden (PATH names an empty directory): available() is False,
    the MSM functions raise Unavailable, and make_bench_case checks nothing
    and raises nothing, for a pinned case the oracle never checked (G1
    2^6) and an unpinned one (Edwards 2^4)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("MSM_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    with pytest.raises(native.Unavailable):
        native.msm_g1_ints([], [])
    for curve, power, pinned in ((G1, 6, True), (ED, 4, False)):
        case = TD.make_bench_case(curve, power)
        assert case.golden_pinned == pinned and not case.oracle_checked
    assert not (tmp_path / "b").exists()
