"""harness/microbench.py of the port and the plain forms it adds, on the
CPU: barrett_mul (ops/field.py) against the JAX package's barrett_mul,
compared as values mod p, on random and extreme canonical operands, both
fields; tree.cu's rate kernel's plain form (ops/kernels.py:word_rate)
against Python integers; run() at 256 lanes returns every row of the
JAX mapping, each naming its entry point; product_study() on the CPU (the
plain form for every form) and the CLI.  The card's tests (cuda-marked:
the -DMSM_MONT_C build of tree.cu, the study's two forms with positive
rates, each held against the plain form) skip here."""

import json
import random

import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu_torch.harness import microbench
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
from webgpu_msm_bls12_377_tpu_torch.params import CurveId

torch.set_num_threads(1)

#: the JAX rows' port names (harness/microbench.py's mapping)
ROWS = ("mont_mul_torch", "barrett_mul_torch", "point_add_torch",
        "masked_add_mixed_cuda", "add_lazy_cuda", "double_and_add_step_cuda",
        "mont_mul_cuda")
CURVES = pytest.mark.parametrize("curve", ["bls12_377", "edwards_bls12"],
                                 ids=["", "ed"])


@CURVES
def test_barrett_mul_equals_jax_mod_p(curve):
    # the JAX package here, so that the card's run (no JAX) collects this
    # file
    import jax

    from webgpu_msm_bls12_377_tpu.ops import field as JF
    from webgpu_msm_bls12_377_tpu.params import CurveId as JCurveId

    ctx, jctx = F.field_ctx(CurveId(curve)), JF.field_ctx(JCurveId(curve))
    p = ctx.p
    rng = random.Random(f"barrett-{curve}")
    extreme = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2,
               1 << (p.bit_length() - 1), (1 << (p.bit_length() - 1)) - 1,
               (1 << 32) - 1, 1 << 32]
    a = [x for x in extreme for _ in extreme] + [rng.randrange(p)
                                                 for _ in range(200)]
    b = [y for _ in extreme for y in extreme] + [rng.randrange(p)
                                                 for _ in range(200)]
    got = F.plane_to_ints(F.barrett_mul(F.ints_to_plane(a, nw=ctx.nw),
                                        F.ints_to_plane(b, nw=ctx.nw), ctx))
    w = jctx.num_words

    def limbs(vals):
        return np.array([[(v >> (13 * i)) & 0x1FFF for v in vals]
                         for i in range(w)], dtype=np.uint32)

    out = np.asarray(jax.jit(lambda x, y: JF.barrett_mul(jctx, x, y))(
        limbs(a), limbs(b))).astype(object)
    want = [sum(int(out[i, j]) << (13 * i) for i in range(w))
            for j in range(out.shape[1])]
    assert [g % p for g in got] == [v % p for v in want]
    assert got == [x * y % p for x, y in zip(a, b)]  # canonical


@CURVES
def test_word_rate_plain_form_is_the_kernels_recurrence(curve):
    """word_rate on CPU tensors: lane s starts from x_k = s 2654435761 +
    40503 k + 1, y_k = x_k ^ 0x9e3779b9 (mod 2^32), runs x = REDC(x y)
    mod R `iters` times and gives the xor of x's words."""
    ctx = F.field_ctx(CurveId(curve))
    p, nw = ctx.p, ctx.nw
    r = 1 << (32 * nw)
    pinv = pow(p, -1, r)
    out = K.word_rate(torch.empty(2 * K.RATE_THREADS, dtype=torch.int32), 5,
                      ctx)
    for s in (0, 1, 255, 256, 511):
        xs = [(s * 2654435761 + k * 40503 + 1) % (1 << 32) for k in range(nw)]
        x = sum(v << (32 * k) for k, v in enumerate(xs))
        y = sum((v ^ 0x9E3779B9) << (32 * k) for k, v in enumerate(xs))
        for _ in range(5):
            t = x * y
            x = (t + (-t * pinv % r) * p) // r % r
        want = 0
        for k in range(nw):
            want ^= (x >> (32 * k)) & 0xFFFFFFFF
        assert int(out[s]) & 0xFFFFFFFF == want, s
    with pytest.raises(ValueError, match="whole blocks"):
        K.word_rate(torch.empty(100, dtype=torch.int32), 1, ctx)


@CURVES
def test_run_returns_every_row_on_the_cpu(curve):
    out = microbench.run(CurveId(curve), 256, 1, device="cpu")
    assert (out["curve"], out["lanes"], out["device"]) == (curve, 256, "cpu")
    assert out["num_words"] == (13 if curve == "bls12_377" else 9)
    for name in ROWS:
        row = out[name]
        assert row["ms"] > 0 and row["M_ops_per_s"] >= 0 and row["entry"]
    assert "lazy" in out["add_lazy_cuda"]["entry"]
    assert "msm_legacy_buckets" in out["masked_add_mixed_cuda"]["entry"]
    assert "bits=1" in out["double_and_add_step_cuda"]["entry"]
    json.dumps(out)


def test_random_planes_are_canonical():
    rng = np.random.RandomState(3)
    for ctx in (F.G1_CTX, F.ED_CTX):
        plane = microbench._plane(rng, ctx, 3 * ctx.nw, 300, "cpu")
        vals = [v for c in range(3)
                for v in F.plane_to_ints(plane[c * ctx.nw:(c + 1) * ctx.nw])]
        assert max(vals) < ctx.p and max(vals).bit_length() == \
            ctx.p.bit_length()


def test_product_study_on_the_cpu():
    """On the CPU both forms run the plain form (one block): the same
    words, the study's keys and positive rates."""
    res = microbench.product_study(CurveId.EDWARDS_BLS12, iters=2,
                                   repeats=1, device="cpu")
    assert (res["device"], res["blocks"], res["num_words"]) == ("cpu", 1, 9)
    assert res["word_products"] == K.RATE_THREADS * 2 * 2 * 81
    assert set(res["forms"]) == set(microbench.FORMS)
    for form in res["forms"].values():
        assert form["word_products_per_s"] > 0 and form["ns_per_product"] > 0
    assert res["forms"]["c_form"]["flags"] == ["-DMSM_MONT_C"]


def test_cli_on_the_cpu(capsys):
    microbench.main(["--lanes", "256", "--iters", "1", "--device", "cpu",
                     "--curve", "edwards_bls12"])
    out = json.loads(capsys.readouterr().out)
    assert set(ROWS) <= set(out)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_c_form_build_of_tree_cu(card):
    """build_variants builds tree.cu's two fields with -DMSM_MONT_C; the
    C form's rate kernel gives the plain form's words."""
    dirs = K.build_variants(("tree",), {"c_form": ("-DMSM_MONT_C",)})
    libs = K.load_variant(dirs["c_form"], ("tree",))
    assert set(libs) == {"tree", "tree_ed"}
    for ctx in (F.G1_CTX, F.ED_CTX):
        out = torch.empty(4 * K.RATE_THREADS, dtype=torch.int32, device=card)
        with K.using(libs):
            K.word_rate(out, 3, ctx)
        assert torch.equal(out, K.word_rate_plain(out.numel(), 3, ctx, card))


@pytest.mark.cuda
@CURVES
def test_product_study_on_the_card(card, curve):
    res = microbench.product_study(CurveId(curve))
    assert set(res["forms"]) == {"chain", "c_form"}
    assert all(f["word_products_per_s"] > 0 for f in res["forms"].values())
