"""The port's sharded engine (parallel/mesh.py) and the batch's device pool
on the CPU, at the JAX package's small test shapes (N = 96, 97 where the
padding matters; chunk 4: 64 windows of 8 buckets; 4 BPR threads).

The JAX sharded tests are slow-marked (minutes of XLA:CPU compiles), so
the yardstick is the bigint oracle of the JAX package's reference
(JAX-free) and the port's single-device engine: the affine result against
reference.msm.naive_msm, the window sums, as points, against
CuzkMsmEngine.msm_device.  The two pieces of the tail that carry kernels
are held against the JAX functions themselves: the join (bpr_add's plain
form) against pallas_kernels.fused_add_lazy in interpret mode, and one
shard's window-block BPR against ops/bpr.py:reduce_buckets_prearranged,
compared mod p.  Shards share the CPU by repeating its device.  The
``cuda`` tests (shards on cuda:0 and cuda:1, and a launch on cuda:1's
operands while cuda:0 is current) skip below two devices.
"""

import random

import numpy as np
import pytest
import torch

# the JAX package's bigint reference (it imports no jax)
from webgpu_msm_bls12_377_tpu.reference import msm as jmsm
from webgpu_msm_bls12_377_tpu_torch.models.cuzk import (
    CuzkMsmEngine,
    mont_point_table,
)
from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
from webgpu_msm_bls12_377_tpu_torch.ops.convert import (
    JAX_NUM_WORDS,
    from_jax_limbs,
    ints_to_words,
)
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.parallel import mesh as M
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv

from test_torch_fused_pieces import same_points

torch.set_num_threads(1)

G1, ED = CurveId.BLS12_377, CurveId.EDWARDS_BLS12
CHUNK, THREADS, NW = 4, 4, 64
OPS = {
    G1: (crv.G1_GENERATOR, crv.g1_scalar_mult, crv.g1_to_affine, jmsm.G1),
    ED: (crv.ED_GENERATOR, crv.ed_scalar_mult, crv.ed_to_affine,
         jmsm.EDWARDS),
}
#: the lanes of one block of the JAX package's lane-wise kernels
#: (pallas_kernels.BLOCK)
BLOCK = 512


def jax_group(curve):
    from webgpu_msm_bls12_377_tpu.ops import curve as jcurve

    return jcurve.G1Ops() if curve == G1 else jcurve.EdwardsOps()


def make_case(curve, n, seed="sharded"):
    """n points k_i G (affine ints), n scalars below 2^253, the oracle's
    affine result."""
    g, mult, to_aff, group = OPS[curve]
    rng = random.Random(f"{seed}-{curve.value}-{n}")
    pts = [mult(g, rng.randrange(1, 1 << 60)) for _ in range(n)]
    scalars = [rng.randrange(0, 1 << 253) for _ in range(n)]
    want = to_aff(jmsm.naive_msm(pts, scalars, group))
    return [to_aff(p) for p in pts], scalars, tuple(want)


CASES = {}


def case(curve=G1, n=96):
    if (curve, n) not in CASES:
        CASES[curve, n] = make_case(curve, n)
    return CASES[curve, n]


def sharded(d, curve=G1, **kw):
    opts = dict(chunk_size=CHUNK, num_bpr_threads=THREADS, smvp_mode="tree",
                tree_finish=2, autotune=False)
    opts.update(kw)
    return M.ShardedMsmEngine(curve, mesh=M.make_mesh(["cpu"] * d), **opts)


def single(curve=G1, **kw):
    opts = dict(chunk_size=CHUNK, num_bpr_threads=THREADS, smvp_mode="tree",
                tree_finish=2, autotune=False, device="cpu")
    opts.update(kw)
    return CuzkMsmEngine(curve, **opts)


def count_joins(monkeypatch):
    """Count the tail's bpr_add calls (the launches on a card)."""
    calls = []
    real = K.bpr_add

    def counted(a, b, group=C.G1):
        calls.append(a.shape[1])
        return real(a, b, group)
    monkeypatch.setattr(K, "bpr_add", counted)
    return calls


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("num_windows", [16, 17, 64])
def test_tail_branch(d, num_windows):
    """Window-sharded where D > 1 is a power of two dividing num_windows
    (chunk 16's 16 windows up to D = 16, chunk 4's 64), else the tree
    fallback (chunk 15's 17 windows at every D)."""
    want = {(2, 16), (4, 16), (8, 16), (2, 64), (4, 64), (8, 64)}
    assert M.window_sharded(d, num_windows) == ((d, num_windows) in want)


@pytest.mark.parametrize("d,n,joins", [
    (2, 96, 2),   # window-sharded: one round, a join a shard
    (4, 96, 8),   # two rounds of four joins
    (3, 96, 2),   # fallback: the tree over three window-sum planes
    (8, 97, 24),  # padding to 104 (13 a shard), three rounds
], ids=["d2", "d4", "d3-fallback", "d8-pad"])
def test_tree_shards_match_oracle_and_single_device(d, n, joins,
                                                    monkeypatch):
    aff, scalars, want = case(G1, n)
    calls = count_joins(monkeypatch)
    eng = sharded(d)
    points, sc = eng._prepare_points(aff), eng._prepare_scalars(scalars)
    sums = eng.msm_device(points, sc, CHUNK)
    assert len(calls) == joins
    assert sums.shape == (39, NW)
    one = single()
    same_points(sums, one.msm_device(points, sc, CHUNK), C.G1)
    got = eng._finalize(sums, CHUNK)
    assert (got["x"], got["y"]) == want


@pytest.mark.parametrize("curve,mode,d", [
    (G1, "stream", 4), (G1, "legacy", 2), (ED, "tree", 4)],
    ids=["stream-d4", "legacy-d2", "ed-tree-d4"])
def test_stream_legacy_and_edwards_shards(curve, mode, d):
    aff, scalars, want = case(curve)
    eng = sharded(d, curve, smvp_mode=mode,
                  tree_finish=2 if mode == "tree" else None)
    assert eng._shard_path(CHUNK, 96 // d) == mode
    got = eng.compute_msm(aff, scalars)
    assert (got["x"], got["y"]) == want


def test_default_path_at_chunk_4_is_legacy():
    """Where the single-device policy takes the fused path (chunk 4), a
    shard takes the legacy bucket sum, as the JAX sharded engine does."""
    eng = sharded(2, smvp_mode="auto", tree_finish=None)
    assert single(smvp_mode="auto", tree_finish=None)._select_smvp(
        CHUNK, 48) == "fused"
    assert eng._shard_path(CHUNK, 48) == "legacy"


def test_wire_bytes_and_fewer_points_than_shards():
    """Point-major wire words shard as views of their rows; with n < D the
    padding fills whole shards."""
    aff, scalars, _ = case(G1)
    eng = sharded(4)
    pts, sc = aff[:3], scalars[:3]
    want = single().compute_msm(pts, sc)
    assert eng.compute_msm(pts, sc) == want
    wire_p = b"".join(x.to_bytes(48, "little") + y.to_bytes(48, "little")
                      for x, y in pts)
    wire_s = b"".join(s.to_bytes(32, "little") for s in sc)
    assert eng.compute_msm(wire_p, wire_s) == want
    words, layout = eng._prepare_points(wire_p)
    view, sub = M.shard_words(words, layout, 1, 2)
    assert np.shares_memory(view, words) and sub.n == 1
    padded, sub = M.shard_words(words, layout, 2, 4)
    assert sub.n == 2 and not padded[1].any()


def mod_p(plane, group):
    nw, p = group.ctx.nw, group.ctx.p
    return [[v % p for v in F.plane_to_ints(plane[c * nw:(c + 1) * nw])]
            for c in range(plane.shape[0] // nw)]


def to_jax(plane, curve):
    """Port plane (Montgomery in R = 2^(32 nw)) -> the JAX package's
    13-bit limbs of the same values mod p in its R = 2^(13 w)."""
    import jax.numpy as jnp

    group = C.group_ops(curve)
    p, nw, w = group.ctx.p, group.ctx.nw, JAX_NUM_WORDS[curve]
    scale = pow(2, 13 * w - 32 * nw, p)
    coords = []
    for c in range(plane.shape[0] // nw):
        vals = [v * scale % p for v in F.plane_to_ints(
            plane[c * nw:(c + 1) * nw])]
        coords.append(jnp.asarray(np.array(
            [[(v >> (13 * i)) & 0x1FFF for v in vals] for i in range(w)],
            dtype=np.uint32)))
    return coords


def lazy_operands(curve, rng):
    """Two (rows, BLOCK) lazy port planes: doubled case points (so
    coordinates above p), identities among the first."""
    group = C.group_ops(curve)
    aff, _, _ = case(curve)
    cw = 12 if curve == G1 else 8
    pw = torch.from_numpy(np.stack([
        ints_to_words([a[0] for a in aff], cw),
        ints_to_words([a[1] for a in aff], cw)]).view(np.int32))
    table = mont_point_table(pw, group)
    out = []
    for _ in range(2):
        pts = group.from_affine(group.split_aff(
            table[:, torch.from_numpy(rng.integers(0, len(aff), BLOCK))]))
        out.append(group.double_lazy(pts))
    zero = torch.from_numpy(rng.random(BLOCK) < 0.1)
    out[0] = group.select(zero, group.zero(BLOCK), out[0])
    return [C.merge(p) for p in out]


@pytest.mark.parametrize("curve,interpret", [(G1, True), (ED, False)],
                         ids=["", "ed"])
def test_join_matches_jax_fused_add_lazy(curve, interpret):
    """bpr_add's plain form against the JAX fused_add_lazy on the same lazy
    planes (one block of lanes; the JAX operands the same values mod p in
    its limbs), every coordinate equal mod p.  G1 runs the JAX kernel in
    interpret mode; Edwards its jnp body (the kernel's interpreter takes
    ~15 s a curve here)."""
    from webgpu_msm_bls12_377_tpu.ops import pallas_kernels

    assert pallas_kernels.BLOCK == BLOCK
    group, jg = C.group_ops(curve), jax_group(curve)
    a, b = lazy_operands(curve, np.random.default_rng(5))
    jtype = type(jg.zero((1,)))
    want = pallas_kernels.fused_add_lazy(
        jg, jtype(*to_jax(a, curve)), jtype(*to_jax(b, curve)),
        interpret=interpret)
    carried = from_jax_limbs(np.concatenate([np.asarray(c) for c in want]),
                             montgomery=True, curve=curve)
    assert mod_p(K.bpr_add(a, b, group), group) == mod_p(carried, group)


def test_window_block_bpr_matches_jax(monkeypatch):
    """One shard's BPR in the window-sharded tail (D = 2: kw = 32 windows,
    its joined buckets in bpr_order(kw)) against the JAX package's
    reduce_buckets_prearranged on the same buckets, equal mod p."""
    from webgpu_msm_bls12_377_tpu.ops import bpr as jbpr

    aff, scalars, want = case(G1)
    eng = sharded(2)
    seen = []
    real = eng._bpr

    def spy(buckets, chunk, width):
        out = real(buckets, chunk, width)
        seen.append((buckets, width, out))
        return out
    monkeypatch.setattr(eng, "_bpr", spy)
    got = eng.compute_msm(aff, scalars)
    assert (got["x"], got["y"]) == want
    assert [s[1] for s in seen] == [NW // 2] * 2
    buckets, kw, port = seen[1]
    jg = jax_group(G1)
    jb = type(jg.zero((1,)))(*to_jax(buckets, G1))
    ref = jbpr.reduce_buckets_prearranged(jg, jb, kw, CHUNK, THREADS)
    carried = from_jax_limbs(np.concatenate([np.asarray(c) for c in ref]),
                             montgomery=True, curve=G1)
    assert mod_p(port, C.G1) == mod_p(carried, C.G1)


@pytest.fixture(scope="module")
def batch():
    """Three scalar sets over the N = 96 points, the last duplicate-heavy
    (six values), each with compute_msm's result on one device."""
    aff, scalars, _ = case(G1)
    rng = random.Random("sharded-batch")
    pool = [rng.randrange(0, 1 << 253) for _ in range(6)]
    sets = [scalars, [rng.randrange(0, 1 << 253) for _ in scalars],
            [rng.choice(pool) for _ in scalars]]
    one = single()
    return aff, sets, [one.compute_msm(aff, s) for s in sets]


def test_sharded_batch_matches_compute_msm(batch, monkeypatch):
    """ShardedMsmEngine.compute_msm_batch at D = 2: the point prep once a
    shard, a tail a set, every set equal to compute_msm, the
    duplicate-heavy one included (no slab overflow: the port has none)."""
    aff, sets, want = batch
    eng = sharded(2)
    preps = []
    real = eng._point_prep
    monkeypatch.setattr(eng, "_point_prep",
                        lambda *a: preps.append(1) or real(*a))
    assert eng.compute_msm_batch(aff, sets) == want
    assert len(preps) == 2
    assert eng.compute_msm_batch(aff, []) == []


def test_device_pool_matches_compute_msm(batch, monkeypatch):
    """compute_msm_batch(devices=["cpu", "cpu"]) on the stream path: set i
    on member i % 2, the point prep once a member, every set (the
    duplicate-heavy one among them) equal to compute_msm."""
    aff, sets, want = batch
    sets, want = sets[1:], want[1:]
    eng = single(smvp_mode="stream", tree_finish=None)
    preps = []
    real = eng._point_prep
    monkeypatch.setattr(eng, "_point_prep",
                        lambda *a: preps.append(a[2]) or real(*a))
    assert eng.compute_msm_batch(aff, sets, devices=["cpu", "cpu"]) == want
    assert preps == [torch.device("cpu")] * 2


def test_make_mesh():
    """No GPU here: the default mesh raises, as a CUDA device in a list
    does; devices repeat; a mesh is one kind of device."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.ShardedMsmEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh(["cuda:0"])
    mesh = M.make_mesh(["cpu"] * 3)
    assert (mesh.size, mesh.local, mesh.rank, mesh.world_size) == (3, 3, 0, 1)
    assert [mesh.index(i) for i in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="at least one"):
        M.make_mesh([])


def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


@pytest.mark.cuda
def test_launch_runs_on_the_operands_device():
    """A kernel launched on cuda:1's operands while cuda:0 is current runs
    on cuda:1 and its stream: bpr_add against its plain form there."""
    two_cards()
    aff, _, _ = case(G1)
    group = C.G1
    planes = C.merge(group.from_affine(group.split_aff(torch.cat([
        F.ints_to_plane([a[c] for a in aff[:64]]) for c in (0, 1)]))))
    a, b = planes.to("cuda:1"), planes.roll(1, dims=1).to("cuda:1")
    with torch.cuda.device(0):
        K.reset_launches()
        got = K.bpr_add(a, b, group)
    assert K.launches["bpr_add"] == 1 and got.device == torch.device("cuda:1")
    assert torch.equal(got.cpu(), K.add_plain(a.cpu(), b.cpu(), group))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tree", "stream", "legacy"])
def test_shards_on_two_cards(mode):
    """Two shards on cuda:0 and cuda:1 (window-sharded at chunk 4), and
    four over them, against the oracle."""
    two_cards()
    aff, scalars, want = case(G1)
    for devices in (["cuda:0", "cuda:1"], ["cuda:0", "cuda:1"] * 2):
        eng = M.ShardedMsmEngine(
            mesh=M.make_mesh(devices), chunk_size=CHUNK,
            num_bpr_threads=THREADS, smvp_mode=mode,
            tree_finish=2 if mode == "tree" else None, autotune=False)
        got = eng.compute_msm(aff, scalars)
        assert (got["x"], got["y"]) == want
