"""Port stream and legacy SMVP paths, the Pippenger and naive engines, and
the path policy, against the JAX package and the bigint oracle (CPU, plain
PyTorch versions of kernels 5, 6 and 7).

Bucket sums: the JAX package's legacy accumulate_buckets (off a TPU its
masked_add_mixed takes the plain jnp branch) at N = 96, chunk 4, as
tests/test_smvp_stream.py runs it, is carried into the port with
from_jax_limbs and must equal the port's legacy accumulate_buckets and its
stream bucket sums word for word: all three run the same RCB mixed add
from the identity in the same entry order, and canonical coordinates have
one representation.  Engines: compute_msm on the stream and legacy paths,
PippengerMsmEngine and NaiveMsmEngine (n = 8) against the oracle and the
JAX PippengerMsmEngine(chunk_size=4).  Exact integer comparisons: no
tolerance.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu.models import PippengerMsmEngine as JPippenger
from webgpu_msm_bls12_377_tpu.models import cuzk as jcuzk
from webgpu_msm_bls12_377_tpu.ops import bpr as jbpr
from webgpu_msm_bls12_377_tpu.ops import buckets as jbuck
from webgpu_msm_bls12_377_tpu.ops import curve as jcurve
from webgpu_msm_bls12_377_tpu.ops import decompose as jdec
from webgpu_msm_bls12_377_tpu.params import CurveId as JCurveId
from webgpu_msm_bls12_377_tpu_torch.models import (
    CuzkMsmEngine,
    NaiveMsmEngine,
    PippengerMsmEngine,
    choose_chunk_size,
)
from webgpu_msm_bls12_377_tpu_torch.models.naive import tree_sum
from webgpu_msm_bls12_377_tpu_torch.ops import bpr, buckets, decompose
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream
from webgpu_msm_bls12_377_tpu_torch.ops.convert import from_jax_limbs, ints_to_words
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import G1, naive_msm

# tiny tensors: one intra-op thread avoids oversubscribing the CPU
# beside the other test workers
torch.set_num_threads(1)

N = 96
CHUNK = 4
THREADS = 4
NW = decompose.num_windows_for(CHUNK)
JG1 = jcurve.G1Ops()
W = 30  # JAX limbs per field element


def carry(pt) -> torch.Tensor:
    """JAX ProjG1 -> port canonical (39, B) plane."""
    return from_jax_limbs(np.concatenate([np.asarray(c) for c in pt]),
                          montgomery=True)


@pytest.fixture(scope="module")
def case():
    rng = random.Random("stream-legacy")
    pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 60))
           for _ in range(N)]
    scalars = [rng.randrange(0, 1 << 253) for _ in range(N)]
    scalars[0], scalars[1], scalars[2] = 0, 1, (1 << 253) - 1
    aff = [crv.g1_to_affine(p) for p in pts]
    pw = np.stack([ints_to_words([a[0] for a in aff], 12),
                   ints_to_words([a[1] for a in aff], 12)])
    return dict(pts=pts, aff=aff, scalars=scalars, pw=pw,
                sw=ints_to_words(scalars, 8))


@pytest.fixture(scope="module")
def jax_buckets(case):
    """The JAX legacy bucket sums and the port's table and plan."""
    table = jcuzk.mont_point_table(JG1.ctx, JG1, jnp.asarray(case["pw"]))
    jplan = jbuck.build_bucket_plan(
        jdec.decompose_scalars_signed(jnp.asarray(case["sw"]), CHUNK, NW), CHUNK)
    rounds = jbuck.round_class(int(np.asarray(jplan.lens).max()))
    legacy = jax.jit(lambda t, p: jbuck.accumulate_buckets(
        JG1, jbuck.table_to_rows(t), p, rounds))(table, jplan)
    ptable = from_jax_limbs(np.asarray(table).reshape(2 * W, N), montgomery=True)
    pplan = buckets.build_bucket_plan(
        decompose.decompose_scalars_signed(
            torch.from_numpy(case["sw"].view(np.int32)), CHUNK, NW), CHUNK)
    assert np.array_equal(pplan.sorted_vals.numpy(), np.asarray(jplan.sorted_vals))
    return dict(jlegacy=legacy, want=carry(legacy), table=ptable, plan=pplan, rounds=rounds)


def test_legacy_accumulate_buckets_matches_jax(jax_buckets):
    s = jax_buckets
    assert buckets.round_class(int(s["plan"].lens.max())) == s["rounds"]
    got = buckets.accumulate_buckets(s["table"], s["plan"], s["rounds"])
    assert torch.equal(got, s["want"])


def test_legacy_window_group_is_a_slice_of_the_whole(jax_buckets):
    """A window group's buckets are the columns of its windows."""
    s = jax_buckets
    h = 1 << (CHUNK - 1)
    idx = torch.as_tensor(buckets.window_slice_indices((1, 5, NW - 1), h))
    plan_g = buckets.BucketPlan(s["plan"].sorted_vals, s["plan"].starts[idx],
                                s["plan"].lens[idx])
    rounds = buckets.round_class(int(plan_g.lens.max()))
    got = buckets.accumulate_buckets(s["table"], plan_g, rounds)
    assert torch.equal(got, s["want"][:, idx])


def test_stream_bucket_sums_match_jax_legacy(jax_buckets):
    s = jax_buckets
    layout = smvp_stream.build_stream_layout(s["plan"].starts, s["plan"].lens, NW)
    blocks = smvp_stream.accumulate_buckets_streamed(
        smvp_stream.build_signed_table(s["table"]), s["plan"].sorted_vals, layout)
    got = smvp_stream.permute_buckets(blocks, layout)
    assert torch.equal(got, s["want"])


def test_legacy_reduction_matches_jax_reduce_buckets(jax_buckets):
    """The JAX legacy BPR (a gather per step, on window-major buckets)
    against the port's legacy reduction: one gather into BPR walk order,
    then the prearranged form.  Canonical window sums, word for word."""
    want = jax.jit(lambda b: jbpr.reduce_buckets(JG1, b, NW, CHUNK, THREADS))(
        jax_buckets["jlegacy"])
    order = torch.as_tensor(bpr.bpr_order(NW, CHUNK, THREADS)).reshape(-1)
    got = bpr.reduce_buckets_prearranged(
        jax_buckets["want"][:, order.to(torch.int64)], NW, CHUNK, THREADS)
    assert torch.equal(got, carry(want))


def engine(cls=CuzkMsmEngine, **kw):
    opts = dict(chunk_size=CHUNK, num_bpr_threads=THREADS, device="cpu")
    opts.update(kw)
    return cls(**opts)


@pytest.fixture(scope="module")
def small_case(case):
    """8 points (the size of the JAX package's naive-engine test): the
    oracle's result and the JAX PippengerMsmEngine's, which must agree."""
    n = 8
    aff, scalars = case["aff"][:n], case["scalars"][:n]
    want = crv.g1_to_affine(naive_msm(case["pts"][:n], scalars, G1))
    jgot = JPippenger(JCurveId.BLS12_377, chunk_size=CHUNK).compute_msm(
        aff, scalars)
    assert (jgot["x"], jgot["y"]) == want
    return aff, scalars, jgot


@pytest.mark.parametrize("mode", ["stream", "legacy"])
def test_compute_msm_stream_and_legacy_match_jax_and_oracle(small_case, mode):
    aff, scalars, want = small_case
    assert engine(smvp_mode=mode).compute_msm(aff, scalars) == want


def test_pippenger_engine_matches_jax_pippenger_and_oracle(small_case):
    aff, scalars, want = small_case
    eng = engine(PippengerMsmEngine)
    assert eng.smvp_mode == "legacy"
    assert eng.compute_msm(aff, scalars) == want
    with pytest.raises(ValueError, match="legacy"):
        PippengerMsmEngine(smvp_mode="stream", device="cpu")


def test_stream_path_duplicate_heavy(case):
    """Every scalar equal: one bucket per window holds all N entries; the
    stream path has no slab cap to overflow."""
    scalars = [0x1234_5678_9ABC_DEF0] * N
    got = engine(smvp_mode="stream").compute_msm(case["aff"], scalars)
    assert (got["x"], got["y"]) == crv.g1_to_affine(
        naive_msm(case["pts"], scalars, G1))


def test_naive_engine_matches_jax_pippenger_and_oracle(case, small_case):
    _, _, want = small_case
    n = 8
    out = NaiveMsmEngine(device="cpu").build_fn()(case["pw"][:, :, :n],
                                                 case["sw"][:, :n])
    assert out.shape == (39, 1)
    got = crv.ProjectivePoint(*(F.plane_to_ints(out[c * 13:(c + 1) * 13])[0]
                                for c in range(3)))
    assert crv.g1_to_affine(got) == (want["x"], want["y"])
    with pytest.raises(ValueError, match="power-of-two"):
        tree_sum(torch.zeros((39, 6), dtype=torch.int32))


@pytest.mark.parametrize("n,chunk,path", [
    (8, 4, "fused"), ((1 << 16) - 1, 4, "fused"), (1 << 16, 15, "stream"),
    ((1 << 18) - 1, 15, "stream"), (1 << 18, 15, "tree"), (1 << 20, 16, "tree"),
])
def test_select_smvp_auto_policy(n, chunk, path):
    """Policy only (no MSM): "auto" answers at every n, as the JAX engine
    does on a TPU (where chunk >= 9 the tree from 2^18 and the stream path
    below, else the fused path where its buckets fill whole blocks, else
    legacy; tests/test_torch_fused_batch.py holds every chunk and n against
    the JAX engine's own policy)."""
    eng = CuzkMsmEngine(device="cpu")
    assert choose_chunk_size(n) == chunk == eng._chunk_for(n)
    assert eng._select_smvp(chunk, n) == path


def test_select_smvp_explicit_modes():
    for mode in ("tree", "stream", "fused", "legacy"):
        assert engine(smvp_mode=mode)._select_smvp(CHUNK, 8) == mode
        assert engine(smvp_mode=mode)._select_smvp(5, 1 << 20) == mode
    assert smvp_stream.stream_supported(9) and not smvp_stream.stream_supported(8)
    # chunk 5..7 fill no whole 256-lane block: "auto" falls to legacy there
    assert engine()._select_smvp(5, 8) == "legacy"
    with pytest.raises(ValueError, match="unknown smvp_mode"):
        engine(smvp_mode="interpret")
