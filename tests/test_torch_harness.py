"""The port's harness/testdata.py against the JAX package's, on the CPU
(the kernels' plain forms make the points): the 2^6 G1 bench case equals
its pinned golden; the Edwards 2^4 case and a text case equal the JAX
seed schemes computed with Python integers and the JAX reference curve;
with the port's 2^6 words in a cache directory under the JAX package's
.npz names, the JAX make_bench_case, make_zipf_case and make_batch_case
return the port's scalar words and expected values, both curves; text
cases saved by either package load in the other; the reference-format
loader parses a fixture as the JAX one does.  The JAX testdata writes its
golden registry and may run its native oracle: here it writes a copy and
its oracle reports itself absent.  Exact equality throughout.
"""

import json
import random
import shutil

import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu.harness import testdata as JTD
from webgpu_msm_bls12_377_tpu.params import CurveId as JCurveId
from webgpu_msm_bls12_377_tpu.reference import curve as jcrv
from webgpu_msm_bls12_377_tpu.reference.msm import EDWARDS as JEDWARDS
from webgpu_msm_bls12_377_tpu.reference.msm import naive_msm
from webgpu_msm_bls12_377_tpu_torch.harness import testdata as TD
from webgpu_msm_bls12_377_tpu_torch.params import CurveId

torch.set_num_threads(1)

G1, ED = CurveId.BLS12_377, CurveId.EDWARDS_BLS12
CURVES = pytest.mark.parametrize("curve", [G1, ED], ids=["", "ed"])


def jcurve(curve):
    return JCurveId(curve.value)


def words_to_ints(w):
    return [sum(int(w[i, j]) << (32 * i) for i in range(w.shape[0]))
            for j in range(w.shape[1])]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The port's 2^6 bench cases of both curves, made once; their words
    kept in a cache directory under the JAX package's .npz names."""
    d = str(tmp_path_factory.mktemp("cache"))
    return d, {c: TD.make_bench_case(c, 6, device="cpu", cache_dir=d)
               for c in (G1, ED)}


@pytest.fixture
def jax_goldens(tmp_path, monkeypatch):
    """The JAX testdata on a copy of goldens.json, its native oracle
    reported absent."""
    path = tmp_path / "goldens.json"
    shutil.copy(JTD.GOLDEN_PATH, path)
    monkeypatch.setattr(JTD, "GOLDEN_PATH", str(path))
    monkeypatch.setattr(JTD, "_native_cross_check", lambda *a: False)
    return path


def test_g1_bench_case_equals_the_pinned_golden(cache):
    _, cases = cache
    case = cases[G1]
    entry = TD.load_goldens()["bls12_377:6:bench-6"]
    assert case.golden_pinned
    assert case.expected == tuple(int(v, 16) for v in entry[:2])
    assert case.oracle_checked == bool(entry[2])
    assert case.point_words.shape == (2, 12, 64)
    assert case.point_words.dtype == case.scalar_words.dtype == np.uint32


def test_edwards_bench_case_equals_the_jax_scheme():
    """2^4 (no golden pins it): ks and scalars from random.Random, points
    k_i * G and the naive MSM on the JAX reference curve, and the
    known-k oracle."""
    case = TD.make_bench_case(ED, 4, device="cpu")
    rng = random.Random("bench-4-edwards_bls12")
    order = JTD.curve_order(JCurveId.EDWARDS_BLS12)
    ks = [rng.randrange(1, order) for _ in range(16)]
    scalars = [rng.randrange(0, 1 << 253) for _ in range(16)]
    pts = [jcrv.ed_scalar_mult(jcrv.ED_GENERATOR, k) for k in ks]
    assert list(zip(words_to_ints(case.point_words[0]),
                    words_to_ints(case.point_words[1]))) == [
        jcrv.ed_to_affine(p) for p in pts]
    assert words_to_ints(case.scalar_words) == scalars
    want = jcrv.ed_to_affine(naive_msm(pts, scalars, JEDWARDS))
    assert case.expected == want and not case.golden_pinned
    kw = TD.randrange_words(TD.MTWords(random.Random("bench-4-edwards_bls12")),
                            1, order, 16)
    assert TD.msm_oracle(case.scalar_words, kw, ED) == dict(zip("xy", want))


@CURVES
@pytest.mark.parametrize("kind", ["bench", "zipf", "batch"])
def test_cases_equal_the_jax_package(cache, jax_goldens, curve, kind):
    """The JAX testdata reads the port's point words from the cache and
    draws its own scalars: the same scalar words and expected values."""
    d, cases = cache
    if kind == "bench":
        got = cases[curve]
        want = JTD.make_bench_case(jcurve(curve), 6, cache_dir=d,
                                   cross_check=False)
        pairs = [(got.scalar_words, want.scalar_words)]
        assert got.expected == want.expected
        assert np.array_equal(got.point_words, want.point_words)
    elif kind == "zipf":
        got = TD.make_zipf_case(curve, 6, pool_bits=3, device="cpu",
                                cache_dir=d)
        want = JTD.make_zipf_case(jcurve(curve), 6, pool_bits=3, cache_dir=d)
        pairs = [(got.scalar_words, want.scalar_words)]
        assert got.expected == want.expected
        assert len(set(words_to_ints(got.scalar_words))) <= 8
    else:
        got = TD.make_batch_case(curve, 6, 2, device="cpu", cache_dir=d)
        want = JTD.make_batch_case(jcurve(curve), 6, 2, cache_dir=d)
        pairs = list(zip(got.scalar_sets, want.scalar_sets))
        assert got.expecteds == want.expecteds and len(pairs) == 2
    for a, b in pairs:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_batch_case_takes_the_pinned_batch_goldens(monkeypatch, tmp_path):
    """Where goldens.json has "{curve}:{power}:{seed}:batch{i}", that is
    the expected value (here a registry pinning set 1 only)."""
    d, n = str(tmp_path), 8
    rng = np.random.RandomState(3)
    kw = TD.randrange_words(TD.MTWords(random.Random("bench-3-bls12_377")), 1,
                            TD.curve_order(G1), n)
    np.savez_compressed(tmp_path / "bench-bls12_377-3-bench-3.npz",
                        point_words=rng.randint(0, 9, (2, 12, n)).astype(
                            np.uint32),
                        scalar_words=np.zeros((8, n), np.uint32))
    golden = tmp_path / "goldens.json"
    golden.write_text(json.dumps({"bls12_377:3:bench-3:batch1": ["0x5",
                                                                  "0x7"]}))
    monkeypatch.setattr(TD, "GOLDEN_PATH", str(golden))
    case = TD.make_batch_case(G1, 3, 2, cache_dir=d)
    sets = TD.batch_scalars(3, 2, G1)
    assert all(np.array_equal(a, b) for a, b in zip(case.scalar_sets, sets))
    assert case.expecteds == [
        tuple(TD.msm_oracle(sets[0], kw, G1).values()), (5, 7)]


def test_make_test_case_equals_the_jax_scheme():
    """generate_points(seed) and scalars from a second random.Random(seed)
    (Edwards, 2^2)."""
    case = TD.make_test_case(ED, 2, device="cpu")
    rng = random.Random("testcase-2")
    order = JTD.curve_order(JCurveId.EDWARDS_BLS12)
    ks = [rng.randrange(1, order) for _ in range(4)]
    rng = random.Random("testcase-2")
    assert case.points == [
        jcrv.ed_to_affine(jcrv.ed_scalar_mult(jcrv.ED_GENERATOR, k))
        for k in ks]
    assert case.scalars == [rng.randrange(0, 1 << 253) for _ in range(4)]
    assert case.curve == ED and case.expected is None


@CURVES
def test_text_cases_load_in_the_other_package(tmp_path, curve):
    rng = random.Random(f"text-{curve.value}")
    pts = [(rng.randrange(1 << 377), rng.randrange(1 << 377)) for _ in range(8)]
    scalars = [rng.randrange(1 << 253) for _ in range(8)]
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    TD.save_test_case(TD.TestCase(curve, pts, scalars, (3, 4)), str(port_dir))
    got = JTD.load_test_case(jcurve(curve), 3, str(port_dir))
    assert (got.points, got.scalars, got.expected) == (pts, scalars, (3, 4))
    JTD.save_test_case(JTD.TestCase(jcurve(curve), pts, scalars), str(jax_dir))
    got = TD.load_test_case(curve, 3, str(jax_dir))
    assert (got.curve, got.points, got.scalars, got.expected) == (
        curve, pts, scalars, None)
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(
        [p.name for p in jax_dir.iterdir()]
        + [f"3-power-expected-{curve.value}.txt"])


@pytest.mark.parametrize("nested", [False, True], ids=["flat", "nested"])
def test_reference_loader_equals_the_jax_one(tmp_path, nested):
    rng = random.Random("reference")
    pts = [(rng.randrange(1 << 377), rng.randrange(1 << 377)) for _ in range(4)]
    scalars = [rng.randrange(1 << 253) for _ in range(4)]
    pdir = tmp_path / "points" if nested else tmp_path
    sdir = tmp_path / "scalars" if nested else tmp_path
    pdir.mkdir(exist_ok=True)
    sdir.mkdir(exist_ok=True)
    (pdir / "16-power-points.txt").write_text("".join(
        f'{{ "x": "{x}", "y": "{y}", "z": "1"}}\n' for x, y in pts))
    (sdir / "16-power-scalars.txt").write_text(
        f'"{scalars[0]}",\n{scalars[1]}\n\n' + "".join(
            f'"{s}",\n' for s in scalars[2:]))
    got = TD.load_reference_test_case(16, str(tmp_path))
    want = JTD.load_reference_test_case(16, str(tmp_path))
    assert (got.points, got.scalars, got.expected) == (
        want.points, want.scalars, want.expected) == (
        pts, scalars, TD.REFERENCE_EXPECTED[16])
    assert got.curve == G1
    with pytest.raises(FileNotFoundError):
        TD.load_reference_test_case(17, str(tmp_path))


def test_reference_expected_and_goldens_read_only(tmp_path):
    assert TD.REFERENCE_EXPECTED == JTD.REFERENCE_EXPECTED
    with open(JTD.GOLDEN_PATH) as f:
        assert TD.load_goldens() == json.load(f)
    assert TD.load_goldens(str(tmp_path / "absent.json")) == {}
    assert not hasattr(TD, "save_goldens")
