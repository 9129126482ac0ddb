"""Port SMVP stages and BPR against the JAX package, at canonical boundaries,
for both curves: BLS12-377 G1 (test ids ``[]``) and Twisted Edwards BLS12
(``[ed]``).

The JAX kernels' bodies are jnp point forms (ops/curve.py:G1Ops,
EdwardsOps); on the CPU the tier-1 tests run those forms directly, since
interpret-mode Pallas compiles take minutes.  Each stage gets the same input
in both packages: JAX-produced state (the Montgomery table, tree level
planes, bucket arrays) is carried into the port with from_jax_limbs, and the
outputs are compared mod p after canonicalization.  The plain PyTorch
versions of kernels 2, 3, 4 and 5 run here; the kernels themselves are held
against those plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu.models import cuzk as jcuzk
from webgpu_msm_bls12_377_tpu.ops import bpr as jbpr
from webgpu_msm_bls12_377_tpu.ops import buckets as jbuck
from webgpu_msm_bls12_377_tpu.ops import curve as jcurve
from webgpu_msm_bls12_377_tpu.ops import decompose as jdec
from webgpu_msm_bls12_377_tpu.ops import smvp_stream as jss
from webgpu_msm_bls12_377_tpu.ops import smvp_tree as jst
from webgpu_msm_bls12_377_tpu_torch.models.cuzk import mont_point_table
from webgpu_msm_bls12_377_tpu_torch.ops import bpr, buckets, decompose
from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
from webgpu_msm_bls12_377_tpu_torch.ops import field as F
from webgpu_msm_bls12_377_tpu_torch.ops import smvp_stream, smvp_tree
from webgpu_msm_bls12_377_tpu_torch.ops.convert import from_jax_limbs, ints_to_words
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv

from test_torch_fused_pieces import same_points

# tiny tensors: one intra-op thread avoids oversubscribing the CPU
# beside the other test workers
torch.set_num_threads(1)

N = 96
CHUNK = 4
LANES = 8  # the JAX finish layout's lanes (the port's layout is flat)
THREADS = 4
NW = decompose.num_windows_for(CHUNK)


class Curve:
    """One curve's port group, JAX group and oracle, as the tests need
    them: W JAX limbs per element, K affine coordinates in the table."""

    def __init__(self, group, jgroup, w, k, cw, point):
        self.group, self.jgroup, self.w, self.k, self.cw = group, jgroup, w, k, cw
        self.point = point  # rng -> an affine point of the oracle
        self.p, self.nw = group.ctx.p, group.ctx.nw

    def carry(self, pt) -> torch.Tensor:
        """JAX point (a tuple, or a merged (k*W, T) plane) -> the port's
        canonical plane."""
        arr = np.concatenate([np.asarray(c) for c in pt]) if isinstance(
            pt, tuple) else np.asarray(pt)
        return from_jax_limbs(arr, montgomery=True, curve=self.group.CURVE)

    def mod_p(self, plane: torch.Tensor) -> np.ndarray:
        """Port plane -> object array of its values mod p, one row per
        coordinate."""
        rows = [F.plane_to_ints(plane[c * self.nw:(c + 1) * self.nw])
                for c in range(plane.shape[0] // self.nw)]
        return np.array([[v % self.p for v in r] for r in rows], dtype=object)


G1 = Curve(C.G1, jcurve.G1Ops(), 30, 2, 12, lambda rng: crv.g1_to_affine(
    crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 60))))
ED = Curve(C.EDWARDS, jcurve.EdwardsOps(), 20, 3, 8, lambda rng: crv.ed_to_affine(
    crv.ed_scalar_mult(crv.ED_GENERATOR, rng.randrange(1, 1 << 60))))


def take(pt, idx):
    idx = jnp.asarray(idx)
    return type(pt)(*(jnp.take(c, idx, axis=1) for c in pt))


@pytest.fixture(scope="module", params=[G1, ED], ids=["", "ed"])
def stage(request):
    """JAX plan state at N = 96, chunk 4, K = 2, plus the port's plans and
    signed table, for one curve."""
    cv = request.param
    rng = random.Random("smvp-bpr" if cv is G1 else "ed-smvp-bpr")
    aff = [cv.point(rng) for _ in range(N)]
    pw = np.stack([ints_to_words([a[0] for a in aff], cv.cw),
                   ints_to_words([a[1] for a in aff], cv.cw)])
    sw = ints_to_words([rng.randrange(0, 1 << 253) for _ in range(N)], 8)
    table = jcuzk.mont_point_table(cv.jgroup.ctx, cv.jgroup, jnp.asarray(pw))
    jplan = jbuck.build_bucket_plan(
        jdec.decompose_scalars_signed(jnp.asarray(sw), CHUNK, NW), CHUNK)
    kn = N * NW
    jh = jst.build_hybrid_plan(jplan.starts, jplan.lens, kn, 2, NW, LANES)
    pplan = buckets.build_bucket_plan(
        decompose.decompose_scalars_signed(torch.from_numpy(sw.view(np.int32)),
                                           CHUNK, NW), CHUNK)
    ph = smvp_tree.build_hybrid_plan(pplan.starts, pplan.lens, kn, 2, NW)
    ptab = smvp_stream.build_signed_table(
        cv.carry(np.asarray(table).reshape(cv.k * cv.w, N)), cv.group)
    return dict(cv=cv, pw=pw, table=table, jplan=jplan, jh=jh, pplan=pplan,
                ph=ph, kn=kn, ptab=ptab)


def decode(level_map: torch.Tensor, t_real: int):
    m = level_map.numpy().astype(np.int64)[:t_real]
    child = m & smvp_tree.CHILD_MASK
    single = (m & smvp_tree.FLAG_SINGLE) != 0
    return child, np.where(single, child, child + 1), single


def jax_level1(s):
    """Level 1 in jnp: both-affine adds of sorted-stream children."""
    cv, ph = s["cv"], s["ph"]
    c1, s1 = smvp_tree.chain_counts(ph.lens, 1)
    t1 = int(s1[-1] + c1[-1])
    ca, cb, single = decode(ph.level_map1, t1)
    ttab = jst.build_tree_table(cv.jgroup, s["table"])
    arr0 = jst.gather_level0(ttab, s["jplan"].sorted_vals, 3)
    coords = [arr0[c * cv.w:(c + 1) * cv.w] for c in range(cv.k)]
    aa = tuple(c[:, ca] for c in coords)
    ab = tuple(c[:, cb] for c in coords)
    added = jax.jit(cv.jgroup.add_affine_lazy)(aa, ab)
    promoted = cv.jgroup.from_affine(aa)
    return jcurve.select(jnp.asarray(single), promoted, added), t1


def jax_level2(s, lvl1):
    ph = s["ph"]
    c1, s1 = smvp_tree.chain_counts(ph.lens, 1)
    c2, s2 = smvp_tree.chain_counts(ph.lens, 2)
    t2 = int(s2[-1] + c2[-1])
    caps = smvp_tree.level_caps(s["kn"], ph.lens.shape[0], 2)
    map2 = smvp_tree.build_level_map(s1, c1, s2, c2, caps[1])
    ca, cb, single = decode(map2, t2)
    pa, pb = take(lvl1, ca), take(lvl1, cb)
    added = jax.jit(s["cv"].jgroup.add_lazy)(pa, pb)
    return jcurve.select(jnp.asarray(single), pa, added), map2, t2


@pytest.fixture(scope="module")
def levels(stage):
    """JAX levels 1 and 2 (lazy) with the port's level-2 map."""
    lvl1, t1 = jax_level1(stage)
    lvl2, map2, t2 = jax_level2(stage, lvl1)
    return dict(lvl1=lvl1, t1=t1, lvl2=lvl2, map2=map2, t2=t2)


def test_tree_table_matches_jax(stage):
    """mont_point_table (the point prep's plain Montgomery table; for
    Edwards with t = x*y) and the signed table (G1: (x, y), then (x, -y);
    Edwards: (x, y, t), then (-x, y, -t)) against the JAX package's."""
    cv = stage["cv"]
    want = cv.carry(np.asarray(stage["table"]).reshape(cv.k * cv.w, N))
    got = mont_point_table(torch.from_numpy(stage["pw"].view(np.int32)), cv.group)
    assert got.shape == (cv.group.aff_rows, N)
    assert torch.equal(got, want)
    jt = np.asarray(jst.build_tree_table(cv.jgroup, stage["table"]))
    assert torch.equal(stage["ptab"][:, :cv.group.aff_rows].T,
                       cv.carry(jt[:2 * N, :cv.k * cv.w].T))
    assert stage["ptab"].shape == (2 * N, 32)
    assert not stage["ptab"][:, cv.group.aff_rows:].any()


@pytest.mark.parametrize("last", [False, True])
def test_tree_level_aff_matches_jax(stage, levels, last):
    cv = stage["cv"]
    lvl1, t1 = levels["lvl1"], levels["t1"]
    want = cv.mod_p(cv.carry(jax.jit(cv.jgroup.canon)(lvl1)))
    got = smvp_tree.run_tree_level(stage["ptab"], stage["ph"].level_map1,
                                   "aff", last, stage["pplan"].sorted_vals,
                                   cv.group)
    assert got.shape == (cv.group.rows, stage["ph"].level_map1.shape[0])
    assert (cv.mod_p(got[:, :t1]) == want).all()
    if last:
        assert (np.array(F.plane_to_ints(got[:cv.nw])) < cv.p).all()
    # slots past the real node count hold the group's identity
    tail = got.shape[1] - t1
    assert (cv.mod_p(got[:, t1:])
            == cv.mod_p(C.merge(cv.group.zero(tail)))).all()


@pytest.mark.parametrize("last", [False, True])
def test_tree_level_full_matches_jax(stage, levels, last):
    cv = stage["cv"]
    lvl2, t2 = levels["lvl2"], levels["t2"]
    want = cv.mod_p(cv.carry(jax.jit(cv.jgroup.canon)(lvl2)))
    got = smvp_tree.run_tree_level(cv.carry(levels["lvl1"]), levels["map2"],
                                   "full", last, group=cv.group)
    assert (cv.mod_p(got[:, :t2]) == want).all()
    if last:
        assert all(v < cv.p for c in cv.group.split(got)
                   for v in F.plane_to_ints(c))


def test_packed_finish_and_permute_match_jax(stage, levels):
    cv, jg = stage["cv"], stage["cv"].jgroup
    lvl2 = levels["lvl2"]
    layout = stage["jh"].layout
    starts = np.asarray(layout.starts_rk).reshape(-1)
    lens = np.asarray(layout.lens_rk).reshape(-1)
    add = jax.jit(jg.add_lazy)
    acc = jg.zero((starts.shape[0],))
    for t in range(int(lens.max())):
        live = jnp.asarray(t < lens)
        node = take(lvl2, np.where(t < lens, starts + t, 0))
        acc = jcurve.select(live, add(acc, node), acc)
    jblocks = jax.jit(jg.canon)(acc)
    rows = smvp_stream.node_rows(cv.carry(lvl2), cv.group)
    blocks = smvp_stream.packed_finish(rows, stage["ph"].layout, cv.group)
    assert (cv.mod_p(blocks) == cv.mod_p(cv.carry(jblocks))).all()
    order = bpr.bpr_order(NW, CHUNK, THREADS)
    jperm = jss.permute_buckets(jg, jnp.concatenate(list(jblocks)), layout,
                                order=order)
    got = smvp_stream.permute_buckets(blocks, stage["ph"].layout, order=order,
                                      group=cv.group)
    assert torch.equal(got, cv.carry(jperm))


def jax_finish(jg, lvl, starts, lens):
    """The JAX finish's order of adds in jnp: per bucket its nodes from
    the identity, canonicalized once."""
    add = jax.jit(jg.add_lazy)
    acc = jg.zero((starts.shape[0],))
    for t in range(int(lens.max())):
        live = jnp.asarray(t < lens)
        node = take(lvl, np.where(t < lens, starts + t, 0))
        acc = jcurve.select(live, add(acc, node), acc)
    return jax.jit(jg.canon)(acc)


def one_chain_finish(rows, starts, lens, group):
    """The finish as one thread a bucket walked it before buckets were cut
    into pieces: per bucket its nodes from the identity, lazily, then
    canonicalized once."""
    starts, lens = torch.as_tensor(starts), torch.as_tensor(lens)
    acc = group.zero(starts.shape[0])
    for t in range(int(lens.max())):
        live = t < lens
        idx = torch.where(live, starts + t, 0)
        new = group.add_lazy(acc, group.split(rows[idx, :group.rows].T))
        acc = group.select(live, new, acc)
    return C.merge(group.canon(acc))


def test_packed_finish_long_and_empty_buckets_match_jax(stage, levels):
    """The finish on node rows over a hand-made layout, in no particular
    order: empty buckets, buckets of one node, of PIECE and PIECE + 1
    nodes, of 200 nodes (longer than a block of threads) and of 9 PIECE +
    5 (ten pieces: four fold levels), and buckets that overlap, against
    the JAX finish's adds on the same nodes (one chain a bucket): word for
    word up to PIECE nodes, where a bucket is one piece; the same point
    beyond, where the pieces are folded pairwise (other projective
    coordinates)."""
    cv, jg = stage["cv"], stage["cv"].jgroup
    lvl2, t2 = levels["lvl2"], levels["t2"]
    piece = smvp_stream.PIECE
    rng = np.random.default_rng(7)
    nb = 300
    lens = rng.integers(0, 12, size=nb)
    lens[rng.random(nb) < 0.2] = 0
    lens[:6] = (1, 200, 0, piece, piece + 1, 9 * piece + 5)
    starts = rng.integers(0, t2 - lens + 1)
    want = cv.carry(jax_finish(jg, lvl2, starts, lens))
    layout = smvp_stream.StreamLayout(
        starts_rk=torch.as_tensor(starts, dtype=torch.int32),
        lens_rk=torch.as_tensor(lens, dtype=torch.int32),
        perm=torch.arange(nb, dtype=torch.int32))
    rows = smvp_stream.node_rows(cv.carry(lvl2), cv.group)
    got = smvp_stream.packed_finish(rows, layout, cv.group)
    assert got.shape == (cv.group.rows, nb)
    short = torch.as_tensor(lens <= piece)
    assert torch.equal(got[:, short], want[:, short])
    assert int((~short).sum()) == 3
    same_points(got[:, ~short], want[:, ~short], cv.group)
    zero = cv.mod_p(C.merge(cv.group.zero(1)))[:, 0]
    assert all((cv.mod_p(got[:, [j]])[:, 0] == zero).all()
               for j in np.flatnonzero(lens == 0))


def test_packed_finish_keeps_the_words_of_short_buckets(stage, levels):
    """Buckets of at most PIECE nodes (every one a single piece), in
    length-sorted and in natural order, beside empty buckets: the finish
    gives the words of one chain a bucket, as before buckets were cut into
    pieces; the plan cuts none of them."""
    cv = stage["cv"]
    lvl2, t2 = levels["lvl2"], levels["t2"]
    piece = smvp_stream.PIECE
    rng = np.random.default_rng(11)
    lens = rng.integers(0, piece + 1, size=120)
    lens[:4] = (0, 1, piece, piece - 1)
    starts = rng.integers(0, t2 - lens + 1)
    rows = smvp_stream.node_rows(cv.carry(lvl2), cv.group)
    for perm in (np.arange(lens.size), np.argsort(-lens, kind="stable")):
        s = torch.as_tensor(starts[perm], dtype=torch.int32)
        ln = torch.as_tensor(lens[perm], dtype=torch.int32)
        layout = smvp_stream.StreamLayout(
            starts_rk=s, lens_rk=ln, perm=torch.as_tensor(np.argsort(perm)))
        plan = smvp_stream.finish_plan(s, ln, rows.shape[0])
        assert int(plan.n_split) == 0 and int(plan.counts.max()) == 1
        assert torch.equal(smvp_stream.packed_finish(rows, layout, cv.group),
                           one_chain_finish(rows, s.long(), ln.long(),
                                            cv.group))


def test_node_rows_round_trip(stage, levels):
    """node_rows: row j holds column j's words, then zeros to a multiple
    of four words (G1 40, Edwards 36), the csrc/curve.cuh node layout."""
    cv = stage["cv"]
    plane = cv.carry(levels["lvl1"])
    rows = smvp_stream.node_rows(plane, cv.group)
    assert rows.shape == (plane.shape[1], 40 if cv is G1 else 36)
    assert torch.equal(rows[:, :cv.group.rows].T, plane)
    assert not rows[:, cv.group.rows:].any()


def bpr_case(cv, table, chunk, threads, seed=4):
    """Random multiples of table points (20 % empty buckets) in BPR walk
    order for NW windows of 2^(chunk-1) buckets, as JAX and port planes."""
    jg = cv.jgroup
    nw = decompose.num_windows_for(chunk)
    h = 1 << (chunk - 1)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, size=nw * h)
    pts = jg.from_affine(tuple(jnp.take(table[c], idx, axis=1)
                               for c in range(cv.k)))
    pts = jax.jit(lambda p: jg.canon(jg.double_lazy(p)))(pts)
    empty = jnp.asarray(rng.random(nw * h) < 0.2)
    pts = jcurve.select(empty, jg.zero((nw * h,)), pts)
    order = bpr.bpr_order(nw, chunk, threads)
    jb = take(pts, order.reshape(-1))
    return nw, jb, cv.carry(jb)


def test_bpr_matches_jax(stage):
    """reduce_buckets_prearranged on JAX-produced canonical buckets
    (random multiples of table points, with empty buckets), at this
    shape's default split (bpt 2: sub-walks of one step): word for
    word."""
    cv, jg = stage["cv"], stage["cv"].jgroup
    _, jb, pb = bpr_case(cv, stage["table"], CHUNK, THREADS)
    want = jbpr.reduce_buckets_prearranged(jg, jb, NW, CHUNK, THREADS)
    got = bpr.reduce_buckets_prearranged(pb, NW, CHUNK, THREADS, cv.group)
    assert got.shape == (cv.group.rows, NW)
    assert torch.equal(got, cv.carry(want))


_JAX_BPR = {}


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("chunk,threads", [(4, 8), (4, 4), (6, 4)],
                         ids=["bpt1", "bpt2", "bpt8"])
def test_bpr_split_matches_jax(stage, chunk, threads, split, monkeypatch):
    """Stage 1 split into sub-walks (bpr_stage1, its plain form here),
    against the JAX reduction of the same buckets: the same points, and
    the same words where the sub-walks are one step each (q = 1: the
    combine then repeats the walk's adds, the last with its operands
    swapped, and the lazy add is symmetric) or the walk is not split;
    other projective coordinates otherwise.  bpt 1 has no steps; a split
    above bpt is cut to bpt, as stage1_split cuts it (bpt sub-walks of
    one step)."""
    cv, jg = stage["cv"], stage["cv"].jgroup
    nw, jb, pb = bpr_case(cv, stage["table"], chunk, threads)
    key = (cv.group.ctx.tag, chunk, threads)
    if key not in _JAX_BPR:
        _JAX_BPR[key] = cv.carry(
            jbpr.reduce_buckets_prearranged(jg, jb, nw, chunk, threads))
    want = _JAX_BPR[key]
    bpt = (1 << (chunk - 1)) // threads
    monkeypatch.setattr(bpr, "stage1_split",
                        lambda lanes, bpt, group: min(split, bpt))
    got = bpr.reduce_buckets_prearranged(pb, nw, chunk, threads, cv.group)
    if split == 1 or split >= bpt:
        assert torch.equal(got, want)
    else:
        assert not torch.equal(got, want)
        same_points(got, want, cv.group)


@pytest.mark.parametrize("stage", [ED], ids=["ed"], indirect=True)
def test_stream_and_tree_bucket_sums_match_jax_legacy(stage):
    """Edwards (G1's: tests/test_torch_stream_legacy.py and
    tests/test_torch_fused_batch.py): the stream kernel's bucket sums
    (plain form), permuted to window-major order, equal the JAX legacy
    sums word for word: canonical hwcd coordinates of the same adds in the
    same order.  The hybrid tree's (K = 1, 2) add in another order: the
    same points."""
    s, cv = stage, stage["cv"]
    jg = cv.jgroup
    rounds = jbuck.round_class(int(np.asarray(s["jplan"].lens).max()))
    legacy = jax.jit(lambda t, p: jbuck.accumulate_buckets(
        jg, jbuck.table_to_rows(t), p, rounds))(s["table"], s["jplan"])
    want = cv.carry(tuple(legacy))
    layout = smvp_stream.build_stream_layout(s["pplan"].starts, s["pplan"].lens,
                                             NW)
    blocks = smvp_stream.accumulate_buckets_streamed(
        s["ptab"], s["pplan"].sorted_vals, layout, cv.group)
    assert torch.equal(smvp_stream.permute_buckets(blocks, layout,
                                                   group=cv.group), want)

    def affine(pl):
        rinv = pow(cv.group.ctx.params.r, -1, cv.p)
        cols = [[v * rinv % cv.p for v in F.plane_to_ints(c)]
                for c in cv.group.split(pl)]
        return [crv.ed_to_affine(crv.ExtendedPoint(*v)) for v in zip(*cols)]

    for k in (1, 2):
        hp = smvp_tree.build_hybrid_plan(s["pplan"].starts, s["pplan"].lens,
                                         s["kn"], k, NW)
        tb = smvp_tree.tree_smvp_hybrid(s["ptab"], s["pplan"].sorted_vals, hp,
                                        k, cv.group)
        got = smvp_stream.permute_buckets(tb, hp.layout, group=cv.group)
        assert affine(got) == affine(want)


@pytest.mark.parametrize("lanes,bpt,want_g1,want_ed", [
    (16 * 512, 64, 4, 4),   # 2^20, chunk 16: 8,192 lanes
    (17 * 512, 32, 2, 4),   # 2^16-2^18, chunk 15: 8,704 lanes
    (64 * 8, 1, 1, 1),      # chunk 4, 8 threads: no steps
    (64 * 4, 2, 2, 2),      # chunk 4, 4 threads: a split above bpt is cut
    (40_000, 64, 1, 1),     # the lanes alone fill the card
])
def test_stage1_split_fills_the_card_in_one_wave(lanes, bpt, want_g1, want_ed):
    """The default split: the largest power of two, at most bpt and
    MAX_SPLIT, with lanes * split within the threads an H100 holds at
    once at bpr_stage1's registers (G1 2 blocks a SM, Edwards 3)."""
    assert bpr.stage1_split(lanes, bpt, C.G1) == want_g1
    assert bpr.stage1_split(lanes, bpt, C.EDWARDS) == want_ed
    for group, split in ((C.G1, want_g1), (C.EDWARDS, want_ed)):
        assert lanes * split <= bpr.STAGE1_RESIDENT[group.ctx.tag] or split == 1
