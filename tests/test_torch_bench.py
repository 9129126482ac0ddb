"""bench_torch.py and the engine methods its flags call, on the CPU (the
kernels' plain forms): every flag prints one JSON line with bench.py's
keys and a checked result; a wrong result and a missing card exit nonzero
with no JSON line; CuzkMsmEngine.debug_check passes at 2^6 and 2^8 on
both curves and raises at a changed digit or bucket word; prewarm in the
background joins and the next call equals the golden; utils/timing.py's
fence and time_fn.  The cases' words
are put in the cache directory first, made with Python integers by the
seed scheme (tests/test_torch_harness.py holds the port's generator to
it).  Tests marked ``cuda`` run on the card (prewarm loads every library;
debug_check at 2^16; a call made while prewarm runs) and skip here.
Exact equality throughout.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import bench_torch
from webgpu_msm_bls12_377_tpu_torch.harness import testdata as TD
from webgpu_msm_bls12_377_tpu_torch.models import cuzk
from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine
from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
from webgpu_msm_bls12_377_tpu_torch.ops.convert import ints_to_words
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv

torch.set_num_threads(1)

G1, ED = CurveId.BLS12_377, CurveId.EDWARDS_BLS12
STAGES = ("stage1_mont_convert", "stage2_transpose", "stage3_buckets")
KEYS = {"n", "chunk_size", "mean_warm_s", "cold_s", "host_finalize_s",
        "input_transfer_s", "runs", "device", "n_devices", "checked",
        "build_s"}
BATCH_KEYS = {"n", "batch", "batched_s", "serial_s", "speedup_vs_serial",
              "host_inputs", "runs", "device", "n_devices", "checked"}


def ops(curve):
    if curve == G1:
        return crv.G1_GENERATOR, crv.g1_scalar_mult, crv.g1_add, \
            crv.g1_to_affine, 12
    return crv.ED_GENERATOR, crv.ed_scalar_mult, crv.ed_add, \
        crv.ed_to_affine, 8


def point_words(points, cw):
    return np.stack([ints_to_words([p[0] for p in points], cw),
                     ints_to_words([p[1] for p in points], cw)])


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The 2^6 bench cases of both curves under their .npz names, by the
    seed scheme with Python integers: ks, then scalars, from
    random.Random(f"bench-6-{curve}"), points k_i * G."""
    d = tmp_path_factory.mktemp("bench-cache")
    for curve in (G1, ED):
        g, mult, _, aff, cw = ops(curve)
        rng = random.Random(f"bench-6-{curve.value}")
        ks = [rng.randrange(1, TD.curve_order(curve)) for _ in range(64)]
        scalars = [rng.randrange(0, 1 << 253) for _ in range(64)]
        np.savez_compressed(
            d / f"bench-{curve.value}-6-bench-6.npz",
            point_words=point_words([aff(mult(g, k)) for k in ks], cw),
            scalar_words=ints_to_words(scalars, 8))
    return str(d)


def run(capsys, *argv):
    """bench_torch.main(argv) -> (exit code, stdout lines)."""
    rc = bench_torch.main(list(argv))
    return rc, capsys.readouterr().out.strip().splitlines()


def result(capsys, cache, *argv):
    rc, lines = run(capsys, "--device", "cpu", "--n", "64", "--runs", "1",
                    "--cache-dir", cache, *argv)
    assert rc == 0
    assert all(line.startswith("#") for line in lines[:-1])
    out = json.loads(lines[-1])
    assert out["unit"] == "points/s" and out["detail"]["checked"] is True
    assert out["detail"]["device"] == "cpu" and out["detail"]["n_devices"] == 1
    assert out["vs_baseline"] == out["value"] / bench_torch.BASELINE_POINTS_PER_SEC
    return out, lines


def test_default_line(capsys, cache):
    """bench.py's keys; value = n / mean_warm_s; the pinned 2^6 golden."""
    out, lines = result(capsys, cache)
    assert out["metric"] == "msm_throughput_2^6_bls12_377"
    assert KEYS <= set(out["detail"]) and out["detail"]["build_s"] is None
    assert out["value"] == 64 / out["detail"]["mean_warm_s"]
    assert out["detail"]["chunk_size"] == 4 and out["detail"]["runs"] == 1
    assert any("golden_pinned=True" in line for line in lines)


@pytest.mark.parametrize("argv", [
    ("--bytes", "--debug", "--prewarm"),
    ("--zipf", "3", "--profile", "PROFILE"),
    ("--same-point", "--smvp-mode", "legacy"),
], ids=["bytes-debug-prewarm", "zipf-profile", "same-point-legacy"])
def test_flags_edwards(capsys, cache, tmp_path, argv):
    argv = [str(tmp_path) if a == "PROFILE" else a for a in argv]
    out, lines = result(capsys, cache, "--curve", "edwards_bls12", *argv)
    assert out["metric"] == "msm_throughput_2^6_edwards_bls12"
    assert KEYS <= set(out["detail"])
    if "--prewarm" in argv:
        assert out["detail"]["prewarm_extra_s"] >= 0
        assert any(line.startswith("# debug stage checks") and
                   str(dict.fromkeys(STAGES, True)) in line for line in lines)
    if "--profile" in argv:
        assert os.listdir(tmp_path) == ["bench_torch_6.json"]
    if "legacy" in argv:
        assert out["detail"]["path"] == "legacy"


@pytest.mark.parametrize("host", [False, True], ids=["staged", "host"])
def test_batch_edwards(capsys, cache, host):
    """--batch 2: bench.py's batch line; staged sets through the engine's
    batch stages, or host words through compute_msm_batch."""
    out, _ = result(capsys, cache, "--curve", "edwards_bls12", "--batch", "2",
                    *(["--batch-host-inputs"] if host else []))
    assert out["metric"] == "msm_batch2_throughput_2^6_edwards_bls12"
    assert BATCH_KEYS <= set(out["detail"])
    assert out["detail"]["host_inputs"] is host
    assert out["value"] == 2 * 64 / out["detail"]["batched_s"]


def test_wrong_result_exits_nonzero(capsys, cache, monkeypatch):
    real = TD.make_bench_case

    def wrong(*a, **kw):
        case = real(*a, **kw)
        case.expected = (case.expected[0] + 1, case.expected[1])
        return case

    monkeypatch.setattr(TD, "make_bench_case", wrong)
    rc, lines = run(capsys, "--device", "cpu", "--n", "64", "--runs", "1",
                    "--curve", "edwards_bls12", "--cache-dir", cache)
    assert rc != 0 and all(line.startswith("#") for line in lines)


def test_missing_card_exits_nonzero(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines = run(capsys, "--n", "64")
    assert rc != 0 and lines == []


def chain_case(curve, n, seed):
    """n distinct points (i + 1) * G, made by additions, and n random
    253-bit scalars, as word arrays."""
    g, _, add, aff, cw = ops(curve)
    pts, acc = [], g
    for _ in range(n):
        pts.append(aff(acc))
        acc = add(acc, g)
    rng = random.Random(seed)
    return point_words(pts, cw), ints_to_words(
        [rng.randrange(1 << 253) for _ in range(n)], 8)


@pytest.mark.parametrize("curve", [G1, ED], ids=["", "ed"])
@pytest.mark.parametrize("power", [6, 8])
def test_debug_check_passes(curve, power):
    pw, sw = chain_case(curve, 1 << power, f"debug-{power}")
    eng = CuzkMsmEngine(curve, device="cpu")
    assert eng.debug_check(pw, sw) == dict.fromkeys(STAGES, True)
    if power == 6:
        # from wire bytes, at another chunk size (5: 51 windows)
        assert eng.debug_check(*TD.to_wire(pw, sw), chunk_size=5) == \
            dict.fromkeys(STAGES, True)


def test_debug_check_finds_a_changed_digit(monkeypatch):
    pw, sw = chain_case(ED, 64, "fault")
    real = cuzk.decompose_scalars_signed

    def changed(*a):
        d = real(*a)
        d[3, 5] = (d[3, 5] + 1) % 16
        return d

    monkeypatch.setattr(cuzk, "decompose_scalars_signed", changed)
    with pytest.raises(AssertionError, match="stage2 digits"):
        CuzkMsmEngine(ED, device="cpu").debug_check(pw, sw)


def test_debug_check_finds_a_changed_bucket_word(monkeypatch):
    """One word of the longest bucket's sum (always sampled) changed."""
    pw, sw = chain_case(G1, 64, "fault")
    real = cuzk.accumulate_buckets_streamed

    def changed(table, sorted_vals, layout, group):
        out = real(table, sorted_vals, layout, group)
        out[0, int(torch.argmax(layout.lens_rk))] ^= 1
        return out

    monkeypatch.setattr(cuzk, "accumulate_buckets_streamed", changed)
    with pytest.raises(AssertionError, match="stage3 bucket"):
        CuzkMsmEngine(G1, device="cpu").debug_check(pw, sw)


def test_prewarm_in_the_background(cache):
    """prewarm(background=True) returns a Thread that ends; the next call
    equals the pinned 2^6 golden."""
    eng = CuzkMsmEngine(device="cpu")
    thread = eng.prewarm(64, background=True)
    thread.join(timeout=300)
    assert not thread.is_alive()
    case = TD.make_bench_case(G1, 6, device="cpu", cache_dir=cache)
    assert case.golden_pinned
    got = eng.compute_msm(case.point_words, case.scalar_words)
    assert (got["x"], got["y"]) == case.expected


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_prewarm_loads_every_library_on_the_card(card):
    CuzkMsmEngine().prewarm(1 << 16)
    assert set(K._libs) == {name for name, _, _ in K.LIBRARIES}


@pytest.mark.cuda
@pytest.mark.parametrize("curve", [G1, ED], ids=["", "ed"])
def test_debug_check_on_the_card(card, curve):
    case = TD.make_bench_case(curve, 16, device=card)
    assert case.golden_pinned
    assert CuzkMsmEngine(curve).debug_check(
        case.point_words, case.scalar_words) == dict.fromkeys(STAGES, True)


@pytest.mark.cuda
def test_call_while_prewarm_runs_on_the_card(card):
    """A call made while prewarm runs in the background (its staging
    threads beside prewarm's launches) equals the 2^16 golden."""
    case = TD.make_bench_case(G1, 16, device=card)
    eng = CuzkMsmEngine()
    thread = eng.prewarm(1 << 16, background=True)
    got = eng.compute_msm(case.point_words, case.scalar_words)
    thread.join(timeout=600)
    assert not thread.is_alive()
    assert (got["x"], got["y"]) == case.expected


def test_timing_fence_and_time_fn():
    """fence waits for nothing on the CPU and walks lists, tuples and
    dicts; time_fn runs warmup + iters calls and returns a mean."""
    from webgpu_msm_bls12_377_tpu_torch.utils.timing import fence, time_fn

    t = torch.zeros(3)
    fence([t, (t, {"a": t})])
    calls = []
    secs = time_fn(lambda x: calls.append(x) or x, t, iters=3, warmup=2)
    assert len(calls) == 5 and secs >= 0
