"""The point prep (kernel 1's entry, TPU kernel rows 1, 1e and 1e+) and the
engine's wire input, on the CPU.

point_prep_plain, the plain form of csrc/convert.cu msm_point_prep, against
the JAX package's mont_point_table (exact after from_jax_limbs: values mod
p) and an independent signed table made with Python integers, for both
curves, both wire layouts (word-major (2, k, N) and point-major (N, 2k))
and both forms (SIGNED, PLANE), at N in {1, 7, 128, 1000} with the
coordinates 0, 1 and p - 1 among random ones (-0 stays 0).  The engine
from wire bytes against the engine from ints and the JAX engine (the
Pallas SMVP kernels in interpret mode), both curves; bytes reach the card
in wire order (no host transpose); the staged copy's chunks cover the
array exactly once.  The kernel itself is held against point_prep_plain
bit for bit on the card (tests/test_torch_cuda.py).
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu.models import cuzk as jcuzk
from webgpu_msm_bls12_377_tpu.models.cuzk import CuzkMsmEngine as JEngine
from webgpu_msm_bls12_377_tpu.ops import curve as jcurve
from webgpu_msm_bls12_377_tpu.params import CurveId as JCurveId
from webgpu_msm_bls12_377_tpu_torch.models import cuzk
from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine
from webgpu_msm_bls12_377_tpu_torch.ops import convert
from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
from webgpu_msm_bls12_377_tpu_torch.ops.convert import WireLayout, from_jax_limbs
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv
from webgpu_msm_bls12_377_tpu_torch.reference.msm import EDWARDS, G1, naive_msm

torch.set_num_threads(1)

#: (port group, JAX group, curve, the JAX package's curve) of each curve
CURVES = {"g1": (C.G1, jcurve.G1Ops(), CurveId.BLS12_377,
                 JCurveId.BLS12_377),
          "ed": (C.EDWARDS, jcurve.EdwardsOps(), CurveId.EDWARDS_BLS12,
                 JCurveId.EDWARDS_BLS12)}
SIZES = (1, 7, 128, 1000)
LAYOUTS = {"word-major": False, "point-major": True}
FORMS = {"signed": K.SIGNED, "plane": K.PLANE}


@functools.lru_cache(maxsize=None)
def wire_case(curve: str, n: int):
    """(point-major (n, 2k) words, the coordinates as ints): random
    coordinates below p with 0, 1 and p - 1 among them."""
    group = CURVES[curve][0]
    p, k = group.ctx.p, group.ctx.nw - 1
    rng = random.Random(f"prep-{curve}-{n}")
    coords = [[rng.randrange(p) for _ in range(n)] for _ in range(2)]
    for i, v in enumerate((0, 1, p - 1, 0, p - 1, 1)):
        coords[i % 2][(3 * i) % n] = v
    buf = b"".join(coords[0][j].to_bytes(4 * k, "little")
                   + coords[1][j].to_bytes(4 * k, "little") for j in range(n))
    words, _ = convert.wire_words(buf, 4 * k, 2)
    return words, coords


@functools.lru_cache(maxsize=None)
def jax_table(curve: str, n: int) -> torch.Tensor:
    """The JAX package's mont_point_table of the case, in the port's
    canonical (26|27, n) Montgomery words."""
    group, jgroup, curve_id, _ = CURVES[curve]
    words, _ = wire_case(curve, n)
    wm = np.ascontiguousarray(words.reshape(n, 2, -1).transpose(1, 2, 0))
    jt = jcuzk.mont_point_table(jgroup.ctx, jgroup, jnp.asarray(wm))
    rows = np.asarray(jt).reshape(-1, n)
    return from_jax_limbs(rows, montgomery=True, curve=curve_id)


def signed_rows(group, coords) -> torch.Tensor:
    """The signed table with Python integers: rows (x, y[, t]) and their
    negatives (G1 (x, -y), Edwards (-x, y, -t)) in Montgomery form, -0 =
    0, zeros to ROW_WORDS."""
    ctx = group.ctx
    p, r, nw = ctx.p, ctx.params.r, ctx.nw
    pos, neg = [], []
    for x, y in zip(*coords):
        xm, ym = x * r % p, y * r % p
        if group is C.G1:
            pos.append((xm, ym))
            neg.append((xm, -ym % p))
        else:
            tm = x * y % p * r % p
            pos.append((xm, ym, tm))
            neg.append((-xm % p, ym, -tm % p))
    rows = [[(v >> (32 * w)) & 0xFFFFFFFF for v in pt for w in range(nw)]
            for pt in pos + neg]
    out = torch.zeros((len(rows), K.ROW_WORDS), dtype=torch.int64)
    out[:, :group.aff_rows] = torch.tensor(rows, dtype=torch.int64)
    return out.to(torch.int32)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("curve", CURVES)
def test_point_prep_plain_matches_jax(curve, n, layout, form):
    group = CURVES[curve][0]
    k = group.ctx.nw - 1
    words, coords = wire_case(curve, n)
    if not LAYOUTS[layout]:
        words = np.ascontiguousarray(words.reshape(n, 2, k).transpose(1, 2, 0))
    lay = WireLayout.of(words, LAYOUTS[layout], k, 2)
    got = K.point_prep(torch.from_numpy(words.view(np.int32).copy()), lay,
                       group, FORMS[form])
    table = jax_table(curve, n)
    if form == "plane":
        assert torch.equal(got, table)
        return
    # the negative of a zero coordinate is zero, never p
    assert torch.equal(got, signed_rows(group, coords))
    assert torch.equal(got, K.build_signed_table(table, group))


@pytest.mark.parametrize("curve", CURVES)
def test_point_prep_checks_its_operands(curve):
    group = CURVES[curve][0]
    k = group.ctx.nw - 1
    words, _ = wire_case(curve, 7)
    t = torch.from_numpy(words.view(np.int32).copy())
    with pytest.raises(ValueError, match="words a coordinate"):
        K.point_prep(t, WireLayout(True, 7, k + 1, 2), group)
    with pytest.raises(ValueError, match="layout"):
        K.point_prep(t[:6], WireLayout.of(words, True, k, 2), group)
    with pytest.raises(ValueError, match="form"):
        K.point_prep(t, WireLayout.of(words, True, k, 2), group, 2)
    with pytest.raises(ValueError, match="shape"):
        WireLayout.of(words, False, k, 2)


@pytest.mark.parametrize("major", LAYOUTS)
def test_layout_strides_and_words(major):
    """The three strides address every word of a C-contiguous array of
    the layout, and word() reads one word of every value."""
    lay = WireLayout(LAYOUTS[major], 5, 3, 2)
    arr = np.arange(30, dtype=np.uint32).reshape(lay.shape)
    sc, sw, sp = lay.strides()
    flat = arr.reshape(-1)
    wm = lay.word_major(torch.from_numpy(arr.view(np.int32)))
    for c in range(2):
        for i in range(3):
            assert np.array_equal(lay.word(arr, c, i),
                                  flat[c * sc + i * sw + sp * np.arange(5)])
            assert np.array_equal(wm[c, i].numpy(), lay.word(arr, c, i))


@pytest.mark.parametrize("rows,row_bytes", [
    (1000, 96), (1 << 17, 96), (1 << 20, 96), (1 << 20, 64), (1 << 20, 32),
    (24, 4 << 20), (16, 4 << 19), (8, 1 << 16), (1, 32), (37, 5 << 20),
    (1 << 18, 96), (1 << 20, 1)])
def test_staged_copy_chunks_cover_the_array(rows, row_bytes):
    """Chunks of whole rows cover [0, rows) in order, each once: the
    points [0, N) of point-major words (96, 64 or 32 bytes a row), the
    word planes of word-major ones (4N bytes a row).  Below STAGE_WORKERS
    chunks' bytes one chunk holds every row; above, each chunk is at most
    STAGE_CHUNK_BYTES or one row."""
    workers = cuzk.STAGE_WORKERS
    chunks = cuzk.staging_chunks(rows, row_bytes)
    covered = [i for lo, hi in chunks for i in range(lo, hi)]
    assert covered == list(range(rows))
    assert all(hi > lo for lo, hi in chunks)
    size = rows * row_bytes
    if size < workers * cuzk.STAGE_CHUNK_BYTES:
        assert chunks == [(0, rows)]
    else:
        assert len(chunks) >= workers
        assert all((hi - lo) * row_bytes <= max(cuzk.STAGE_CHUNK_BYTES,
                                                row_bytes)
                   for lo, hi in chunks)


@pytest.mark.parametrize("major", LAYOUTS)
def test_words_to_device_keeps_shape_and_bits(major):
    words, _ = wire_case("g1", 128)
    if not LAYOUTS[major]:
        words = np.ascontiguousarray(words.reshape(128, 2, 12).transpose(1, 2, 0))
    got = cuzk.words_to_device(words, torch.device("cpu"))
    assert got.shape == words.shape and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), words)


# -- the engine from wire bytes -----------------------------------------------

N = 24


def engine_case(curve: str):
    """(affine points, scalars, point bytes, scalar bytes, oracle)."""
    rng = random.Random(f"prep-engine-{curve}")
    if curve == "g1":
        pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 60))
               for _ in range(N)]
        aff, cb = [crv.g1_to_affine(p) for p in pts], 48
    else:
        pts = [crv.ed_scalar_mult(crv.ED_GENERATOR, rng.randrange(1, 1 << 60))
               for _ in range(N)]
        aff, cb = [crv.ed_to_affine(p) for p in pts], 32
    scalars = [rng.randrange(0, 1 << 253) for _ in range(N)]
    scalars[0], scalars[1] = 0, (1 << 253) - 1
    pbuf = b"".join(x.to_bytes(cb, "little") + y.to_bytes(cb, "little")
                    for x, y in aff)
    sbuf = b"".join(s.to_bytes(32, "little") for s in scalars)
    if curve == "g1":
        want = crv.g1_to_affine(naive_msm(pts, scalars, G1))
    else:
        want = crv.ed_to_affine(naive_msm(pts, scalars, EDWARDS))
    return aff, scalars, pbuf, sbuf, {"x": want[0], "y": want[1]}


#: (port path, the JAX engine's interpret mode) by curve
JAX_MODE = {"g1": ("tree", "tree-interpret"),
            "ed": ("stream", "stream-interpret")}


@pytest.mark.parametrize("curve", CURVES)
def test_engine_from_bytes_matches_ints_and_jax(curve, monkeypatch):
    """Every path from wire bytes (the signed table of tree and stream, the
    Montgomery table of fused and legacy) equals the path from ints and
    from word arrays, the oracle, and the JAX engine from the same bytes
    (its SMVP kernels under the Pallas interpreter); no call makes the
    host transpose wire bytes (words_by_row)."""
    aff, scalars, pbuf, sbuf, want = engine_case(curve)
    _, _, curve_id, jcurve_id = CURVES[curve]
    path, jmode = JAX_MODE[curve]
    jeng = JEngine(jcurve_id, chunk_size=4, smvp_mode=jmode,
                   tree_finish=2 if path == "tree" else None,
                   stream_lanes=8, num_bpr_threads=4)
    assert jeng.compute_msm(pbuf, sbuf) == want
    transposed = []
    real = convert.words_by_row
    monkeypatch.setattr(convert, "words_by_row",
                        lambda w: transposed.append(w.shape) or real(w))
    for mode in ("tree", "stream", "fused", "legacy"):
        eng = CuzkMsmEngine(curve_id, chunk_size=4, num_bpr_threads=4,
                            smvp_mode=mode, device="cpu")
        assert eng.compute_msm(pbuf, sbuf) == want
        assert eng.compute_msm(bytearray(pbuf), memoryview(sbuf)) == want
        assert not transposed
        assert eng.compute_msm(aff, scalars) == want
    k = 12 if curve == "g1" else 8
    pw = np.stack([convert.ints_to_words([a[c] for a in aff], k)
                   for c in range(2)])
    eng = CuzkMsmEngine(curve_id, chunk_size=4, num_bpr_threads=4,
                        smvp_mode=path, device="cpu")
    assert eng.compute_msm(pw, convert.ints_to_words(scalars, 8)) == want
    assert eng.compute_msm_batch(pbuf, [sbuf, scalars]) == [want, want]


def test_prepared_bytes_stay_in_wire_order():
    """Bytes come out of input normalization as a point-major view of the
    buffer; scalars as (N, 8); word arrays as given."""
    aff, scalars, pbuf, sbuf, _ = engine_case("g1")
    eng = CuzkMsmEngine(device="cpu")
    words, lay = eng._prepare_points(pbuf)
    assert lay == WireLayout(True, N, 12, 2) and words.shape == (N, 24)
    assert np.shares_memory(words, np.frombuffer(pbuf, dtype=np.uint8))
    swords, slay = eng._prepare_scalars(sbuf)
    assert slay == WireLayout(True, N, 8) and swords.shape == (N, 8)
    # a memoryview of wider items is read by its bytes, not its items
    wide = memoryview(np.frombuffer(sbuf, dtype=np.uint32))
    assert np.array_equal(eng._prepare_scalars(wide)[0], swords)
    arr = convert.ints_to_words(scalars, 8)
    assert eng._prepare_scalars(arr) == (arr, WireLayout(False, N, 8))
    sw = eng._scalars_to_device((swords, slay))
    assert torch.equal(sw, torch.from_numpy(arr.view(np.int32)))


@pytest.mark.parametrize("curve", CURVES)
def test_scalars_from_bytes_at_2_253_are_refused(curve):
    _, scalars, pbuf, _, _ = engine_case(curve)
    eng = CuzkMsmEngine(CURVES[curve][2], chunk_size=4, num_bpr_threads=4,
                        smvp_mode="tree", device="cpu")
    for bad in (1 << 253, (1 << 256) - 1):
        sbuf = b"".join(s.to_bytes(32, "little") for s in scalars[:-1] + [bad])
        with pytest.raises(ValueError, match="2\\^253"):
            eng.compute_msm(pbuf, sbuf)
    with pytest.raises(ValueError, match="mismatch"):
        eng.compute_msm(pbuf, b"\0" * 32 * (N - 1))
    with pytest.raises(ValueError, match="multiple"):
        eng.compute_msm(pbuf[:-1], b"\0" * 32 * N)


def test_mont_point_table_is_the_plain_plane():
    """cuzk.mont_point_table (word-major words) is point_prep_plain's
    PLANE form, and the JAX package's table."""
    words, _ = wire_case("ed", 7)
    wm = np.ascontiguousarray(words.reshape(7, 2, 8).transpose(1, 2, 0))
    got = cuzk.mont_point_table(torch.from_numpy(wm.view(np.int32)), C.EDWARDS)
    assert torch.equal(got, jax_table("ed", 7))
