"""chip_smoke.py's bench inputs, on the CPU: the bulk draws equal
random.Random's own, word for word and in the generator's state after them;
the product-tree inversion equals pow(z, -1, p); a tiny bench case equals
the seed scheme computed with Python integers and the bigint oracle; the
MSM oracle of the bench cases equals the naive bigint MSM; phase 2's
product, fold and tree-sum cases are made on the CPU too; the running-sum
chain of a tiny case is the oracle's; the kernel table covers every
path; and the native oracle's step runs on tiny cases (host points, the
engines' plain forms) and fails on a golden it misses.  Exact equality
throughout.
"""

import random
import shutil

import numpy as np
import pytest
import torch

import chip_smoke as cs
from webgpu_msm_bls12_377_tpu_torch import params as PP
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import EDWARDS, G1, naive_msm

torch.set_num_threads(1)


def words_to_ints(w: np.ndarray) -> list[int]:
    return [sum(int(w[i, j]) << (32 * i) for i in range(w.shape[0]))
            for j in range(w.shape[1])]


@pytest.mark.parametrize("lo,hi", [
    (0, 1 << 253), (1, PP.SCALAR_FIELD), (1, PP.EDWARDS_SUBGROUP_CHARACTERISTIC),
    (0, 1000), (5, (1 << 32) + 7), (0, 1 << 64), (3, (1 << 96) - 1)])
def test_randrange_words_equals_random(lo, hi):
    """Two runs of draws in a row, as bench_case makes them, then the
    next output: the bulk stream moved exactly as far as random did."""
    rng = random.Random(f"draws-{lo}-{hi}")
    words = cs.MTWords(random.Random(f"draws-{lo}-{hi}"))
    for count in (300, 41):
        want = [rng.randrange(lo, hi) for _ in range(count)]
        got = cs.randrange_words(words, lo, hi, count)
        assert got.shape == (8, count) and got.dtype == np.uint32
        assert words_to_ints(got) == want
    assert int(words.peek(1)[0]) == rng.getrandbits(32)


@pytest.mark.parametrize("ctx", [F.G1_CTX, F.ED_CTX], ids=["", "ed"])
def test_batch_inverse_equals_pow(ctx):
    rng = random.Random(f"inverse{ctx.tag}")
    p, r = ctx.p, ctx.params.r
    vals = [rng.randrange(1, p) for _ in range(32)]
    z = F.ints_to_plane([v * r % p for v in vals], nw=ctx.nw)
    got = F.plane_to_ints(cs.batch_inverse(z, ctx))
    assert got == [pow(v, -1, p) * r % p for v in vals]
    with pytest.raises(ValueError):
        cs.batch_inverse(z[:, :3], ctx)


@pytest.mark.parametrize("curve", ["bls12_377", "edwards_bls12"],
                         ids=["", "ed"])
def test_bench_case_equals_the_seed_scheme(curve, monkeypatch):
    """bench_case at 2^3 on the CPU (plain forms of kernels 1 and 4)
    against the scheme of harness/testdata.py:make_bench_case with Python
    integers: ks and scalars from random.Random, points k_i * G from the
    oracle."""
    monkeypatch.setattr(cs, "DEV", "cpu")
    power, n = 3, 8
    pw, sw, kw = cs.bench_case(power, curve)
    rng = random.Random(f"bench-{power}-{curve}")
    if curve == "bls12_377":
        ks = [rng.randrange(1, PP.SCALAR_FIELD) for _ in range(n)]
        pts = [crv.g1_to_affine(crv.g1_scalar_mult(crv.G1_GENERATOR, k))
               for k in ks]
        cw = 12
    else:
        ks = [rng.randrange(1, PP.EDWARDS_SUBGROUP_CHARACTERISTIC)
              for _ in range(n)]
        pts = [crv.ed_to_affine(crv.ed_scalar_mult(crv.ED_GENERATOR, k))
               for k in ks]
        cw = 8
    scalars = [rng.randrange(0, 1 << 253) for _ in range(n)]
    assert pw.shape == (2, cw, n) and sw.shape == (8, n) and kw.shape == (8, n)
    assert list(zip(words_to_ints(pw[0]), words_to_ints(pw[1]))) == pts
    assert words_to_ints(sw) == scalars
    assert words_to_ints(kw) == ks == cs.words_to_ints(kw)


@pytest.mark.parametrize("curve", ["bls12_377", "edwards_bls12"],
                         ids=["", "ed"])
def test_msm_oracle_equals_the_naive_msm(curve, monkeypatch):
    """The oracle below 2^16, (sum of s_i k_i mod r) * G, on a tiny bench
    case: the sum of s_i * (k_i * G) point by point."""
    monkeypatch.setattr(cs, "DEV", "cpu")
    pw, sw, kw = cs.bench_case(3, curve)
    scalars, ks = words_to_ints(sw), words_to_ints(kw)
    if curve == "bls12_377":
        pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, k) for k in ks]
        want = crv.g1_to_affine(naive_msm(pts, scalars, G1))
    else:
        pts = [crv.ed_scalar_mult(crv.ED_GENERATOR, k) for k in ks]
        want = crv.ed_to_affine(naive_msm(pts, scalars, EDWARDS))
    assert cs.msm_oracle(sw, kw, curve) == {"x": want[0], "y": want[1]}


@pytest.mark.parametrize("ctx", [F.G1_CTX, F.ED_CTX], ids=["", "ed"])
def test_phase2_product_and_fold_cases_on_the_cpu(ctx, monkeypatch):
    """field_cases and fold_cases build their operands on the CPU too
    (where the wrappers take the plain forms, so each case equals itself):
    every extreme operand is below R, the product lanes hold every pair of
    them, and the fold's buckets reach 2,048 pieces."""
    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C

    monkeypatch.setattr(cs, "DEV", "cpu")
    ext = cs.extreme_values(ctx)
    r = 1 << (32 * ctx.nw)
    assert all(0 <= v < r for v in ext) and r - 1 in ext
    cases = cs.field_cases(random.Random(1), ctx, n=16)
    assert [c[0] for c in cases] == ["field_mul_lanes" + ctx.tag] * 2
    for _, got, want in cases:
        assert got.shape == (ctx.nw, len(ext) ** 2 + 16)
        assert torch.equal(got, want)
    group = C.G1 if ctx is F.G1_CTX else C.EDWARDS
    (name, got, want), = cs.fold_cases(random.Random(2), group)
    assert name == "fold_pieces" + ctx.tag and got.shape[0] == group.rows
    assert torch.equal(got, want)


@pytest.mark.parametrize("ctx", [F.G1_CTX, F.ED_CTX], ids=["", "ed"])
def test_phase2_finish_case_on_the_cpu(ctx, monkeypatch):
    """finish_cases builds its layout on the CPU too (the wrapper takes the
    plain form, so the case equals itself): length-sorted disjoint buckets
    of 0, 1, PIECE, PIECE + 1 and 130 PIECE + 5 nodes, the longer two cut
    into pieces."""
    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S

    monkeypatch.setattr(cs, "DEV", "cpu")
    group = C.G1 if ctx is F.G1_CTX else C.EDWARDS
    calls = []
    real = S.packed_finish_plain
    monkeypatch.setattr(S, "packed_finish_plain", lambda r, s, ln, g: (
        calls.append(ln.tolist()), real(r, s, ln, g))[1])
    (name, got, want), = cs.finish_cases(random.Random(5), group)
    assert name == "packed_finish" + ctx.tag and got.shape == (group.rows, 500)
    assert torch.equal(got, want)
    lens = calls[0]
    assert lens == sorted(lens, reverse=True)
    assert {0, 1, S.PIECE, S.PIECE + 1, 130 * S.PIECE + 5} <= set(lens)
    assert cs.PARTS["packed_finish" + ctx.tag] == "finish_fold" + ctx.tag


@pytest.mark.parametrize("ctx", [F.G1_CTX, F.ED_CTX], ids=["", "ed"])
def test_phase2_fold_split_case_on_the_cpu(ctx, monkeypatch):
    """fold_split_cases builds its layout on the CPU too, at 600 buckets
    (the wrapper takes the plain form, so the case equals itself): most
    buckets of 2-3 pieces, six each of FOLD_LONE, FOLD_LONE + 1 and 131
    pieces, none of them first or last; and its default is more buckets
    than the fold's 2,048 blocks of 64 threads."""
    import inspect

    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream as S

    monkeypatch.setattr(cs, "DEV", "cpu")
    group = C.G1 if ctx is F.G1_CTX else C.EDWARDS
    calls = []
    real = S.packed_finish
    monkeypatch.setattr(S, "packed_finish", lambda r, lay, g, plan: (
        calls.append(lay.lens_rk.tolist()), real(r, lay, g, plan))[1])
    (name, got, want), = cs.fold_split_cases(random.Random(6), group,
                                             slots=600)
    assert name == "packed_finish" + ctx.tag and got.shape == (group.rows, 600)
    assert torch.equal(got, want)
    pieces = [max(1, -(-n // S.PIECE)) for n in calls[0]]
    assert sum(2 <= c <= 3 for c in pieces) == 600 - 18
    for c in (S.FOLD_LONE, S.FOLD_LONE + 1, 131):
        at = [i for i, k in enumerate(pieces) if k == c]
        assert len(at) == 6 and 0 < min(at) and max(at) < 599
    slots = inspect.signature(cs.fold_split_cases).parameters["slots"].default
    assert slots > 2048 * 64


@pytest.mark.parametrize("ctx", [F.G1_CTX, F.ED_CTX], ids=["", "ed"])
def test_phase2_prep_cases_on_the_cpu(ctx, monkeypatch):
    """prep_cases builds the point prep's four cases (two layouts, two
    forms) on the CPU: the wire words hold 0, 1, p - 1 and p, and each
    case equals itself (the wrapper takes the plain form here)."""
    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C

    monkeypatch.setattr(cs, "DEV", "cpu")
    group = C.G1 if ctx is F.G1_CTX else C.EDWARDS
    k = ctx.nw - 1
    words = cs.wire_point_words(random.Random(3), ctx, 64)
    vals = {sum(int(w) << (32 * i) for i, w in enumerate(row[c * k:(c + 1) * k]))
            for row in words for c in range(2)}
    assert {0, 1, ctx.p - 1, ctx.p} <= vals
    cases = cs.prep_cases(random.Random(3), group, n=64)
    assert [c[0] for c in cases] == ["point_prep" + ctx.tag] * 4
    shapes = {tuple(c[1].shape) for c in cases}
    assert shapes == {(128, 32), (group.aff_rows, 64)}
    for _, got, want in cases:
        assert torch.equal(got, want)


def test_kernel_table_covers_every_path():
    """Every kernel has a source and a home path; the fused paths fold in
    one launch of the fold, not kernel 2's levels; phase 2's lane checks
    are no path's kernels; the legacy SMVP and the scalar multiplication
    are homed on the legacy and naive paths, the join on the sharded
    run."""
    named = {k for names in cs.PATHS.values() for k in names}
    assert named == set(cs.KERNELS) == set(cs.HOME)
    for path in ("fused_10", "fused", "fused_forced", "ed_fused_10",
                 "ed_fused"):
        assert any(k.startswith("fold_pieces") for k in cs.PATHS[path])
        assert not any(k.startswith("tree_level") for k in cs.PATHS[path])
    assert not set(cs.LANE_CHECKS) & set(cs.KERNELS)
    assert cs.KERNELS["fold_pieces_ed"][0].endswith("csrc/tree.cu")
    # every path that converts points does so through the point prep, and
    # the Montgomery table of the legacy, naive and chain paths too
    for path, names in cs.PATHS.items():
        if "mont_mul_const" in names or "mont_mul_const_ed" in names:
            assert {"point_prep", "point_prep_ed"} & set(names)
    assert cs.HOME["point_prep"] == "tree" and cs.HOME["point_prep_ed"] == "ed_tree"
    # rows 11 and 12a: one launch a run on the legacy and naive paths (the
    # 2^14 legacy case sums pieces and folds them), homed there; the
    # fold's row stays the fused path's
    for tag in ("", "_ed"):
        assert cs.KERNELS["legacy_buckets" + tag][1].endswith(
            "pallas_kernels.py:272")
        assert cs.KERNELS["scalar_mult" + tag][1].endswith(
            "pallas_kernels.py:488")
        pre = "ed_" if tag else ""
        assert cs.HOME["legacy_buckets" + tag] == pre + "legacy"
        assert cs.HOME["scalar_mult" + tag] == pre + "naive"
        assert "fold_pieces" + tag in cs.PATHS[pre + "legacy_14"]
        assert cs.HOME["fold_pieces" + tag] == pre + "fused_10"
    assert set(cs.ONCE) <= {k for k in cs.KERNELS}
    # rows 12b and 12c: the naive engine's tree sum and the running-sum
    # chain, one launch a run each, homed on their paths; no one-step
    # canonical kernel is left
    for tag in ("", "_ed"):
        pre = "ed_" if tag else ""
        assert cs.KERNELS["tree_sum" + tag][1].endswith("pallas_kernels.py:302")
        assert cs.KERNELS["running_sum" + tag][1].endswith(
            "pallas_kernels.py:415")
        assert cs.HOME["tree_sum" + tag] == pre + "naive"
        assert cs.HOME["running_sum" + tag] == pre + "running_sum"
        assert {"fused_add" + tag, "fused_running_add" + tag}.isdisjoint(
            cs.KERNELS)
    assert {"tree_sum", "running_sum"} <= set(cs.ONCE)
    # the sharded tail's join: row 8's lane-wise kernel, homed on the
    # multi-device phase's 2^20 D = 2 run, and phase 4 times it there
    for tag, pre in (("", ""), ("_ed", "ed_")):
        assert cs.KERNELS["bpr_add" + tag][1].endswith("pallas_kernels.py:435")
        assert cs.HOME["bpr_add" + tag] == pre + "sharded_2"
        assert cs.TIMED[pre + "sharded_2"] == ("bpr_add" + tag,)
    assert set(cs.TIMED) <= set(cs.PATHS)


@pytest.mark.parametrize("curve", ["bls12_377", "edwards_bls12"],
                         ids=["", "ed"])
def test_phase2_tree_cases_and_chain_on_the_cpu(curve, monkeypatch):
    """tree_cases builds its planes on the CPU (narrow widths here; the
    wrapper takes the plain form, so each case equals itself), widths
    1 and 2 among them and each plane twice; the running-sum chain of a
    tiny bench case (one running_sum over the step-major walk, BPR stage 1
    over the same walk) is the oracle's lane 0."""
    from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
    from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K

    monkeypatch.setattr(cs, "DEV", "cpu")
    group = C.G1 if curve == "bls12_377" else C.EDWARDS
    cases = cs.tree_cases(random.Random(4), group, widths=(16,))
    assert [c[0] for c in cases] == ["tree_sum" + group.ctx.tag] * 10
    assert [c[1].shape for c in cases] == [(group.rows, 1)] * 10
    for _, got, want in cases:
        assert torch.equal(got, want)
    pw, _, _ = cs.bench_case(3, curve)
    K.reset_launches()
    calls = []
    real = K.running_sum
    monkeypatch.setattr(K, "running_sum", lambda *a: (
        calls.append(a[3]), real(*a))[1])
    assert cs.running_sum_chain(pw, curve) == cs.running_sum_oracle(pw, curve)
    assert calls == [8]


def host_points_from_ks(curve, k_words, device=None):
    """testdata.points_from_ks with Python integers (kernel 7's plain form
    is slow on the CPU)."""
    if curve == PP.CurveId.BLS12_377:
        mult, gen, to_aff, cw = (crv.g1_scalar_mult, crv.G1_GENERATOR,
                                 crv.g1_to_affine, 12)
    else:
        mult, gen, to_aff, cw = (crv.ed_scalar_mult, crv.ED_GENERATOR,
                                 crv.ed_to_affine, 8)
    aff = [to_aff(mult(gen, k)) for k in words_to_ints(k_words)]
    return np.array([[[(pt[c] >> (32 * i)) & 0xFFFFFFFF for pt in aff]
                      for i in range(cw)] for c in (0, 1)], dtype=np.uint32)


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")
def test_native_step_on_the_cpu(monkeypatch, tmp_path):
    """native_runs with 2^4 standing for 2^20's goldens, 2^3 for
    make_test_case's 2^16 and 2^3, 2^4 for the Edwards 2^10 and 2^14
    runs, every engine on the CPU: the oracle agrees throughout; a golden
    it misses fails the step."""
    from webgpu_msm_bls12_377_tpu_torch.harness import testdata as TD
    from webgpu_msm_bls12_377_tpu_torch.models import cuzk

    monkeypatch.setattr(TD, "points_from_ks", host_points_from_ks)
    monkeypatch.setattr(cs, "DEV", "cpu")
    monkeypatch.setattr(cuzk, "resolve_device", lambda device: torch.device(
        device or "cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setenv("MSM_AUTOTUNE_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "NATIVE_GOLDEN_POWER", 4)
    monkeypatch.setattr(cs, "NATIVE_TEST_POWER", 3)
    monkeypatch.setattr(cs, "NATIVE_ED_POWERS", (3, 4))
    inputs, ed_inputs, goldens = {}, {}, {}
    for curve, words in (("bls12_377", inputs), (cs.ED, ed_inputs)):
        for power in (3, 4):
            pw, sw, kw = cs.bench_case(power, curve)
            words[power] = pw, sw
            want = cs.msm_oracle(sw, kw, curve)
            goldens[f"{curve}:{power}:bench-{power}"] = [
                hex(want["x"]), hex(want["y"]), True]
    cs.native_runs(goldens, inputs, ed_inputs)
    goldens[f"{cs.ED}:4:bench-4"][0] = hex(1)
    with pytest.raises(SystemExit, match="differs"):
        cs.native_runs(goldens, inputs, ed_inputs)
