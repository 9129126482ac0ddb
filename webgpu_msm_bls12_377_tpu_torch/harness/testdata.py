"""Test cases: generate, save and load MSM inputs and their expected
results, read the pinned goldens, and check a case with the native oracle.

The port's copy of the JAX package's harness/testdata.py, under its
names and with its seed schemes, so that a case here holds the same words
as the JAX one:
- make_bench_case: points P_i = k_i * G with known k_i, 253-bit scalars,
  both drawn from random.Random(f"{seed}-{curve}"), seed "bench-{power}";
  the expected result is (sum of s_i k_i mod r) * G (msm_oracle: n
  multiply-adds and one scalar multiplication on the host), held against
  test-data/goldens.json where that pins the case.  Where no golden pins
  the case, or its golden records no native-oracle check, the native C++
  oracle (native/) sums the case's own points (cross_check, the default),
  and oracle_checked says whether a check, recorded or made now, holds.
  The goldens are read, never written: the port upgrades no pin on disk.
- make_zipf_case: the same points, scalars drawn zipf(alpha) from a pool
  of 2^pool_bits values (duplicate-heavy buckets).
- make_batch_case: scalar sets over the same points (no oracle check).
- make_test_case / save_test_case / load_test_case: the reference's text
  format; load_reference_test_case: the reference's own fixture format.

Draws come in bulk (MTWords / randrange_words: numpy's MT19937 gives the
words random.Random would), and the points are made on the device: kernel
7's scalar multiplication over the broadcast generator
(ops/kernels.py:scalar_mult), made affine there by batch_inverse.  On the
CPU the same calls take the kernels' plain forms.  `device` None means
the first CUDA device, as for the engines.  cache_dir, where given, keeps
a case's words in an .npz under the JAX package's name for it, which
either package reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import zlib
from pathlib import Path

import numpy as np
import torch

from .. import native
from ..models.cuzk import resolve_device, words_to_device
from ..ops import curve as C
from ..ops import field as F
from ..ops import kernels as K
from ..params import (
    BLS12_377_G1_GENERATOR_X,
    BLS12_377_G1_GENERATOR_Y,
    EDWARDS_GENERATOR_X,
    EDWARDS_GENERATOR_Y,
    EDWARDS_SUBGROUP_CHARACTERISTIC,
    SCALAR_FIELD,
    CurveId,
)
from ..reference import curve as ocurve

DATA_DIR = str(Path(__file__).resolve().parents[2] / "test-data")
GOLDEN_PATH = os.path.join(DATA_DIR, "goldens.json")
REFERENCE_DIR = os.path.join(DATA_DIR, "reference")
#: bits of a canonical wire scalar (scalars are below 2^253)
SCALAR_BITS = 253


@dataclasses.dataclass
class TestCase:
    """Points and scalars, and the expected affine result."""

    curve: CurveId
    points: list[tuple[int, int]]  # affine
    scalars: list[int]
    expected: tuple[int, int] | None = None


@dataclasses.dataclass
class BenchCase:
    """Word-array bench inputs and their expected result."""

    curve: CurveId
    point_words: np.ndarray  # (2, 12|8, n) uint32, word-major
    scalar_words: np.ndarray  # (8, n) uint32
    expected: tuple[int, int]
    golden_pinned: bool  # goldens.json pins this case (and agrees)
    oracle_checked: bool  # the native oracle agreed: as the golden
                          # records, or in this call


@dataclasses.dataclass
class BatchCase:
    """One point set and several scalar sets, each with its expected
    result."""

    curve: CurveId
    point_words: np.ndarray
    scalar_sets: list[np.ndarray]  # each (8, n) uint32
    expecteds: list[tuple[int, int]]


def curve_order(curve) -> int:
    """Order of the prime subgroup the engines work in."""
    if CurveId(curve) == CurveId.BLS12_377:
        return SCALAR_FIELD
    return EDWARDS_SUBGROUP_CHARACTERISTIC


def load_goldens(path: str | None = None) -> dict:
    """The golden registry ({} where there is none); GOLDEN_PATH is read
    at call time."""
    path = path or GOLDEN_PATH
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


# ---------------------------------------------------------------------------
# Bulk draws
# ---------------------------------------------------------------------------


class MTWords:
    """The 32-bit outputs of a random.Random from its current state on,
    drawn in bulk by numpy's MT19937 (the same generator, so the same
    words): peek(n) shows the next n, consume(n) moves past them."""

    def __init__(self, rng: random.Random):
        state = rng.getstate()[1]
        self.gen = np.random.MT19937()
        self.gen.state = {"bit_generator": "MT19937", "state": {
            "key": np.array(state[:624], dtype=np.uint32), "pos": state[624]}}
        self.buf = np.empty(0, dtype=np.uint32)

    def peek(self, n: int) -> np.ndarray:
        if self.buf.size < n:
            more = self.gen.random_raw(max(n - self.buf.size, 1 << 20))
            self.buf = np.concatenate([self.buf, more.astype(np.uint32)])
        return self.buf[:n]

    def consume(self, n: int) -> None:
        self.buf = self.buf[n:]


def randrange_words(words: MTWords, lo: int, hi: int, count: int) -> np.ndarray:
    """count draws of random.Random.randrange(lo, hi), in order, as an
    (8, count) uint32 array (value = sum of word i << 32 i).  CPython's
    randrange is lo + _randbelow(hi - lo): getrandbits(k), k the bit length
    of hi - lo, built from ceil(k / 32) outputs, the lowest word first and
    the top one shifted right to its k bits, drawn again while the value is
    at least hi - lo.  Here every candidate is one block of outputs; the
    first count blocks below hi - lo are the draws."""
    n = hi - lo
    k = n.bit_length()
    nwd = -(-k // 32)
    bound = [(n >> (32 * i)) & 0xFFFFFFFF for i in range(nwd)]
    out = []
    need = count
    while need:
        blocks = words.peek(nwd * (2 * need + 1024)).reshape(-1, nwd).copy()
        blocks[:, -1] >>= 32 * nwd - k
        below = np.zeros(len(blocks), dtype=bool)
        equal = np.ones(len(blocks), dtype=bool)
        for i in reversed(range(nwd)):
            below |= equal & (blocks[:, i] < bound[i])
            equal &= blocks[:, i] == bound[i]
        idx = np.flatnonzero(below)[:need]
        words.consume(nwd * (int(idx[-1]) + 1 if idx.size == need else len(blocks)))
        out.append(blocks[idx])
        need -= idx.size
    vals = np.zeros((count, 8), dtype=np.uint64)
    vals[:, :nwd] = np.concatenate(out)
    carry = np.full(count, lo, dtype=np.uint64)
    for i in range(8):
        s = vals[:, i] + carry
        vals[:, i], carry = s & 0xFFFFFFFF, s >> 32
    if carry.any():
        raise ValueError("randrange_words: values reach 2^256")
    return np.ascontiguousarray(vals.astype(np.uint32).T)


def words_to_ints(words: np.ndarray) -> list[int]:
    """(k, n) uint32 words -> n Python ints."""
    return sum(words[i].astype(object) << (32 * i)
               for i in range(words.shape[0])).tolist()


# ---------------------------------------------------------------------------
# Points k_i * G on the device
# ---------------------------------------------------------------------------


def batch_inverse(z: torch.Tensor, ctx) -> torch.Tensor:
    """Lane-wise inverses of a (nw, n) plane of nonzero canonical
    Montgomery values, n a power of two, in Montgomery form: Montgomery's
    trick as a product tree, up by pairs and down again (2 (n - 1) plain
    lane-wise products on z's device) around one inversion on the host."""
    if z.shape[1] & (z.shape[1] - 1):
        raise ValueError("batch_inverse: n must be a power of two")
    if bool(F.is_zero(z).any()):
        raise ValueError("batch_inverse: a zero lane")
    levels = [z]
    while levels[-1].shape[1] > 1:
        t = levels[-1]
        levels.append(F.mont_mul_canon(t[:, 0::2].contiguous(),
                                       t[:, 1::2].contiguous(), ctx))
    # root = Z R for the product Z of the lanes: Z^-1 R = R^2 / root
    root = F.plane_to_ints(levels[-1])[0]
    inv = ctx.col(ctx.params.r2 * pow(root, -1, ctx.p) % ctx.p, z.device)
    for t in reversed(levels[:-1]):
        nxt = torch.empty_like(t)
        nxt[:, 0::2] = F.mont_mul_canon(inv, t[:, 1::2].contiguous(), ctx)
        nxt[:, 1::2] = F.mont_mul_canon(inv, t[:, 0::2].contiguous(), ctx)
        inv = nxt
    return inv


def points_from_ks(curve, k_words: np.ndarray, device=None) -> np.ndarray:
    """(2, 12|8, n) uint32 word-major affine words of the points k_i * G
    for the (8, n) words of k_i (0 < k_i < curve_order): one launch of
    kernel 7's scalar multiplication over the broadcast generator (253
    bits) on `device`, then batch_inverse there.  The lanes are padded to
    a power of two with k = 1."""
    group = C.group_ops(CurveId(curve))
    ctx = group.ctx
    nw, mp = ctx.nw, ctx.params
    if group is C.G1:
        gen_affine = (BLS12_377_G1_GENERATOR_X, BLS12_377_G1_GENERATOR_Y)
    else:
        gx, gy = EDWARDS_GENERATOR_X, EDWARDS_GENERATOR_Y
        gen_affine = (gx, gy, gx * gy % mp.p)
    dev = resolve_device(device)
    n = k_words.shape[1]
    lanes = 1 << max(n - 1, 0).bit_length()
    ks = np.zeros((8, lanes), dtype=np.uint32)
    ks[:, :n] = k_words
    ks[0, n:] = 1
    gen = F.ints_to_plane([mp.to_mont(v) for v in gen_affine], nw=nw).to(dev)
    # the generator's Montgomery table column in every lane
    table = gen.T.reshape(-1, 1).expand(-1, lanes).contiguous()
    res = K.scalar_mult(table, torch.from_numpy(ks.view(np.int32)).to(dev),
                        SCALAR_BITS, group)
    # x, y and the last coordinate z (Edwards: (x, y, t, z))
    proj = group.canon(group.split(res))
    zinv = batch_inverse(proj[-1], ctx)
    aff = K.mont_mul_const(C.merge(tuple(F.mont_mul_canon(c, zinv, ctx)
                                         for c in proj[:2])), 1, ctx)
    # wire coordinates: the plane's words but the top one, zero below p
    pw = aff.cpu().numpy().view(np.uint32).reshape(2, nw, lanes)
    return np.ascontiguousarray(pw[:, :nw - 1, :n])


def generate_points(curve, n: int, seed: str = "hello",
                    device=None) -> list[tuple[int, int]]:
    """n affine points k_i * G, the k_i drawn from random.Random(seed)
    below the curve order (the JAX package's generate_points)."""
    kw = randrange_words(MTWords(random.Random(seed)), 1, curve_order(curve), n)
    pw = points_from_ks(curve, kw, device)
    return list(zip(words_to_ints(pw[0]), words_to_ints(pw[1])))


def msm_oracle(sw: np.ndarray, ks: np.ndarray, curve) -> dict[str, int]:
    """The MSM of scalars sw over points k_i * G with Python integers: the
    sum of s_i * P_i is (sum of s_i k_i mod r) * G, r the order of G: n
    multiply-adds and one scalar multiplication."""
    if CurveId(curve) == CurveId.BLS12_377:
        mult, gen, to_aff = (ocurve.g1_scalar_mult, ocurve.G1_GENERATOR,
                             ocurve.g1_to_affine)
    else:
        mult, gen, to_aff = (ocurve.ed_scalar_mult, ocurve.ED_GENERATOR,
                             ocurve.ed_to_affine)
    total = sum(a * b for a, b in zip(words_to_ints(sw), words_to_ints(ks)))
    x, y = to_aff(mult(gen, total % curve_order(curve)))
    return {"x": x, "y": y}


def to_wire(pw: np.ndarray, sw: np.ndarray) -> tuple[bytes, bytes]:
    """Bench words -> the reference's wire bytes: x||y little-endian
    coordinates a point (48 or 32 bytes each), 32-byte scalars."""
    return (np.ascontiguousarray(pw.transpose(2, 0, 1)).tobytes(),
            np.ascontiguousarray(sw.T).tobytes())


# ---------------------------------------------------------------------------
# Bench, zipf and batch cases
# ---------------------------------------------------------------------------


def _bench_inputs(curve: CurveId, power: int, seed: str, device, cache_dir):
    """(point words, scalar words, k words) of the bench case: ks, then
    scalars, drawn from random.Random(f"{seed}-{curve}"); the point and
    scalar words from cache_dir's .npz where it has them, else made (and
    kept there when cache_dir is given)."""
    n = 1 << power
    words = MTWords(random.Random(f"{seed}-{curve.value}"))
    kw = randrange_words(words, 1, curve_order(curve), n)
    path = cache_dir and os.path.join(
        cache_dir, f"bench-{curve.value}-{power}-{seed}.npz")
    if path and os.path.exists(path):
        with np.load(path) as blob:
            return blob["point_words"], blob["scalar_words"], kw
    sw = randrange_words(words, 0, 1 << SCALAR_BITS, n)
    pw = points_from_ks(curve, kw, device)
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(path, point_words=pw, scalar_words=sw)
    return pw, sw, kw


def bench_words(power: int, curve="bls12_377", device=None):
    """The bench case's (point words (2, 12|8, n), scalar words (8, n),
    k words (8, n)) at seed "bench-{power}", made on `device`."""
    return _bench_inputs(CurveId(curve), power, f"bench-{power}", device, None)


def make_bench_case(curve, power: int, seed: str | None = None, device=None,
                    cache_dir: str | None = None,
                    cross_check: bool = True) -> BenchCase:
    """Distinct-point bench case at n = 2^power.  The expected result is
    the known-k identity; where goldens.json pins "{curve}:{power}:{seed}"
    the pin must equal it (AssertionError otherwise).  oracle_checked is
    the golden's record; where that is missing or False and cross_check
    is set, the native oracle sums the case's points
    (_native_cross_check: True where it agrees, AssertionError where it
    does not, False where it is unavailable).  Unlike the JAX package,
    this writes no golden and upgrades no pin: the registry stays as it
    is on disk."""
    curve = CurveId(curve)
    seed = seed or f"bench-{power}"
    pw, sw, kw = _bench_inputs(curve, power, seed, device, cache_dir)
    got = msm_oracle(sw, kw, curve)
    expected = (got["x"], got["y"])
    key = f"{curve.value}:{power}:{seed}"
    entry = load_goldens().get(key)
    oracle_checked = False
    if entry is not None:
        if tuple(int(v, 16) for v in entry[:2]) != expected:
            raise AssertionError(
                f"golden mismatch for {key}: registry vs known-k identity")
        oracle_checked = bool(entry[2]) if len(entry) > 2 else False
    if cross_check and not oracle_checked:
        oracle_checked = _native_cross_check(curve, pw, sw, expected)
    return BenchCase(curve, pw, sw, expected, entry is not None,
                     oracle_checked)


def _native_cross_check(curve, point_words: np.ndarray,
                        scalar_words: np.ndarray,
                        expected: tuple[int, int]) -> bool:
    """The native oracle's sum of the case's wire bytes (to_wire) against
    `expected`: True where they agree, AssertionError where they do not,
    False where the oracle is unavailable (no g++)."""
    if not native.available():
        return False
    fn = (native.msm_g1 if CurveId(curve) == CurveId.BLS12_377
          else native.msm_edwards)
    got = fn(*to_wire(point_words, scalar_words))
    if got != tuple(expected):
        raise AssertionError(f"native oracle disagrees with the known-k "
                             f"identity: {got} vs {tuple(expected)}")
    return True


def staged_inputs(engine, point_words, scalar_words):
    """An engine's prepared points and scalars (msm_device's inputs) with
    their words staged on its device once, so that msm_device copies
    nothing: the JAX harness's inputs put on the device before a timed
    run.  The words take compute_msm's array and wire forms."""
    return tuple((words_to_device(words, engine.device), layout)
                 for words, layout in (engine._prepare_points(point_words),
                                       engine._prepare_scalars(scalar_words)))


def zipf_scalars(curve, n: int, pool_bits: int = 8, alpha: float = 1.2,
                 seed: str = "bench-0") -> np.ndarray:
    """(8, n) scalar words drawn zipf(alpha) from a pool of 2^pool_bits
    values: the pool from random.Random(label), the ranks from
    np.random.RandomState(crc32(label)).choice with P(rank r) in
    proportion to 1 / (r + 1)^alpha, label "zipf-{seed}-{curve}-{pool_bits}-
    {alpha}"."""
    label = f"zipf-{seed}-{CurveId(curve).value}-{pool_bits}-{alpha}"
    size = 1 << pool_bits
    pool = randrange_words(MTWords(random.Random(label)), 0, 1 << SCALAR_BITS,
                           size)
    weights = np.array([1.0 / (r + 1) ** alpha for r in range(size)])
    weights /= weights.sum()
    picks = np.random.RandomState(zlib.crc32(label.encode())).choice(
        size, size=n, p=weights)
    return np.ascontiguousarray(pool[:, picks])


def make_zipf_case(curve, power: int, pool_bits: int = 8, alpha: float = 1.2,
                   seed: str | None = None, device=None,
                   cache_dir: str | None = None) -> BenchCase:
    """Duplicate-heavy case: the bench case's points, scalars from
    zipf_scalars (every window digit takes at most 2^pool_bits values, so
    a few buckets hold most entries).  Expected: the known-k identity."""
    curve = CurveId(curve)
    seed = seed or f"bench-{power}"
    pw, _, kw = _bench_inputs(curve, power, seed, device, cache_dir)
    sw = zipf_scalars(curve, 1 << power, pool_bits, alpha, seed)
    got = msm_oracle(sw, kw, curve)
    return BenchCase(curve, pw, sw, (got["x"], got["y"]), False, False)


def batch_scalars(power: int, num_sets: int, curve="bls12_377",
                  seed: str | None = None) -> list[np.ndarray]:
    """num_sets (8, 2^power) scalar sets, drawn in order from
    random.Random(f"{seed}-{curve}-batch"), seed "bench-{power}"."""
    seed = seed or f"bench-{power}"
    words = MTWords(random.Random(f"{seed}-{CurveId(curve).value}-batch"))
    return [randrange_words(words, 0, 1 << SCALAR_BITS, 1 << power)
            for _ in range(num_sets)]


def make_batch_case(curve, power: int, num_sets: int, seed: str | None = None,
                    device=None, cache_dir: str | None = None) -> BatchCase:
    """num_sets scalar sets (batch_scalars) over the bench case's points;
    set i's expected value is the golden "{curve}:{power}:{seed}:batch{i}"
    where goldens.json has it, else the known-k identity."""
    curve = CurveId(curve)
    seed = seed or f"bench-{power}"
    pw, _, kw = _bench_inputs(curve, power, seed, device, cache_dir)
    sets = batch_scalars(power, num_sets, curve, seed)
    goldens = load_goldens()
    expecteds = []
    for i, sw in enumerate(sets):
        entry = goldens.get(f"{curve.value}:{power}:{seed}:batch{i}")
        if entry is None:
            got = msm_oracle(sw, kw, curve)
            expecteds.append((got["x"], got["y"]))
        else:
            expecteds.append(tuple(int(v, 16) for v in entry[:2]))
    return BatchCase(curve, pw, sets, expecteds)


# ---------------------------------------------------------------------------
# Text I/O (saveTestCaseToFile.ts's format: one decimal number a line)
# ---------------------------------------------------------------------------


def make_test_case(curve, power: int, seed: str | None = None,
                   device=None) -> TestCase:
    """Random case at n = 2^power: generate_points(seed), and scalars drawn
    from a second random.Random(seed) (the JAX package's scheme)."""
    curve = CurveId(curve)
    n = 1 << power
    seed = seed or f"testcase-{power}"
    points = generate_points(curve, n, seed, device)
    sw = randrange_words(MTWords(random.Random(seed)), 0, 1 << SCALAR_BITS, n)
    return TestCase(curve=curve, points=points, scalars=words_to_ints(sw))


def _case_path(directory: str, power: int, kind: str, curve) -> str:
    return os.path.join(directory,
                        f"{power}-power-{kind}-{CurveId(curve).value}.txt")


def save_test_case(case: TestCase, directory: str = DATA_DIR) -> None:
    """Points (x, then y, a line each), scalars and the expected result
    where there is one, in three files named by power and curve."""
    os.makedirs(directory, exist_ok=True)
    power = len(case.points).bit_length() - 1
    with open(_case_path(directory, power, "points", case.curve), "w") as f:
        for x, y in case.points:
            f.write(f"{x}\n{y}\n")
    with open(_case_path(directory, power, "scalars", case.curve), "w") as f:
        for k in case.scalars:
            f.write(f"{k}\n")
    if case.expected is not None:
        with open(_case_path(directory, power, "expected", case.curve),
                  "w") as f:
            f.write(f"{case.expected[0]}\n{case.expected[1]}\n")


def _read_ints(path: str) -> list[int]:
    with open(path) as f:
        return [int(line) for line in f if line.strip()]


def load_test_case(curve, power: int, directory: str = DATA_DIR) -> TestCase:
    """The case save_test_case wrote."""
    nums = _read_ints(_case_path(directory, power, "points", curve))
    exp_path = _case_path(directory, power, "expected", curve)
    expected = None
    if os.path.exists(exp_path):
        vals = _read_ints(exp_path)
        expected = (vals[0], vals[1])
    return TestCase(curve=CurveId(curve), points=list(zip(nums[0::2],
                                                          nums[1::2])),
                    scalars=_read_ints(_case_path(directory, power, "scalars",
                                                  curve)),
                    expected=expected)


# ---------------------------------------------------------------------------
# The reference's own test vectors
# ---------------------------------------------------------------------------

#: The reference's expected affine results of its 2^16..2^20 BLS12-377
#: cases (src/test-data/testCases.ts:11-32, getExpectedResult).  Their
#: point and scalar payloads live in the reference's LFS store and are not
#: in this repository; load_reference_test_case reads them from
#: REFERENCE_DIR when they are put there.
REFERENCE_EXPECTED: dict[int, tuple[int, int]] = {
    16: (
        94006842082116618334698674554269938560504658220442275405704974851793018623976750030932275315377339755327327987799,
        20373698276638985490622302772174938574967913528479846848006540077491753947648956036093654307050792702539840457541,
    ),
    17: (
        206224560584082546776307678440614275320062113355561962308721799926405988566792861311857124914191508657092244026797,
        211505771810605149801236229583532591257930087722075039263647957125630724803810862016000585191202320499088754389346,
    ),
    18: (
        213590253091531711003295174396041900486736230199904022674226470027355022490783453188751023812621283421365133044335,
        166168294849747437548140695864136486986897221068029518430368940173172785864820517559403857089626657281214248033436,
    ),
    19: (
        227918075012010659569854027573177112762469117095506192259456355647196733855535622181356473956903755312919537388289,
        232048820726736272000228087347068589163288439026577981179126188061989792518064409423298246183820422050991578154066,
    ),
    20: (
        105645455159295492078411402285457085811978509815703136952786959329738979428758249440990135440135199333488003965024,
        217434031274260429359512002379640961971443333898312105830518865556255108267359047513395163712830071551228264849716,
    ),
}


def load_reference_test_case(power: int,
                             directory: str = REFERENCE_DIR) -> TestCase:
    """A BLS12-377 case in the reference's own text formats: points one
    JSON object a line, '{ "x": "...", "y": "...", "z": "..."}' (decimal
    strings, z = 1); scalars one '"<decimal>",' (or a bare decimal) a
    line.  The files sit at the reference's nested layout
    (points/{p}-power-points.txt, scalars/{p}-power-scalars.txt) or flat
    in `directory`; FileNotFoundError where neither is."""

    def find(*cands: str) -> str:
        for c in cands:
            path = os.path.join(directory, c)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(
            f"reference fixture not found: {cands} under {directory}")

    pts_path = find(os.path.join("points", f"{power}-power-points.txt"),
                    f"{power}-power-points.txt")
    sc_path = find(os.path.join("scalars", f"{power}-power-scalars.txt"),
                   f"{power}-power-scalars.txt")
    points = []
    with open(pts_path) as f:
        for line in f:
            if line.strip():
                obj = json.loads(line)
                points.append((int(obj["x"]), int(obj["y"])))
    scalars = []
    with open(sc_path) as f:
        for line in f:
            line = line.strip().rstrip(",").strip('"')
            if line:
                scalars.append(int(line))
    return TestCase(curve=CurveId.BLS12_377, points=points, scalars=scalars,
                    expected=REFERENCE_EXPECTED.get(power))
