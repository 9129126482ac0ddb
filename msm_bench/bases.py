"""The fixed bases: n affine points P_i = k_i G whose k_i the benchmark
knows, made with plain Python integers and kept once per checkout.

A commitment key's points have no structure a program could use, and the
reference needs their discrete logarithms.  Both hold for sums of four
table points: four tables of TABLE_SIZE points t_j[v] = (c_j + v e_j) G,
with c_j and e_j drawn from a fixed label, and P_i = t_0[a_i] + t_1[b_i]
+ t_2[c_i] + t_3[d_i], the indices drawn from the same label, no two rows
alike.  So k_i = sum_j (c_j + idx_ij e_j) mod the group order.  Two sums
of a few bases coincide only where every table's indices add up alike
(about 2^-48 for a pair), so the points' partial sums in a bucket meet no
more often than those of random points.  Making a point costs three
additions, against some 380 for a double-and-add.

The bases do not depend on --seed: only the scalars do.  They are cached
as .npz under CACHE (git-ignored), keyed by curve, n and SCHEME.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import random
import zlib
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from . import curves
from .curves import mul

SCHEME = "t4x4096-v1"
TABLES, TABLE_SIZE = 4, 4096
CACHE = Path(__file__).resolve().parent / ".cache" / "bases"
#: points a worker process sums at a time; below this many points in all
#: the bases are made in this process
CHUNK = 1 << 15


@dataclasses.dataclass
class Bases:
    curve: type
    wire: np.ndarray  # (n, 2 * coord words) uint32: the wire bytes' words
    idx: np.ndarray  # (n, TABLES) uint16: the table indices of each point
    cs: list[int]
    es: list[int]

    @property
    def n(self) -> int:
        return self.wire.shape[0]

    def log(self, i: int) -> int:
        """k_i, the discrete logarithm of point i."""
        return sum(c + int(v) * e for c, e, v in
                   zip(self.cs, self.es, self.idx[i])) % self.curve.order

    def point(self, i: int) -> tuple[int, int]:
        cw = self.curve.coord_bytes // 4
        row = self.wire[i].tobytes()
        return (int.from_bytes(row[:4 * cw], "little"),
                int.from_bytes(row[4 * cw:], "little"))


def _label(curve, n: int) -> str:
    return f"msm_bench-bases-{curve.name}-{n}-{SCHEME}"


def table_logs(curve, n: int) -> tuple[list[int], list[int]]:
    """(c_j, e_j) of the four tables."""
    rnd = random.Random(_label(curve, n))
    cs = [rnd.randrange(1, curve.order) for _ in range(TABLES)]
    es = [rnd.randrange(1, curve.order) for _ in range(TABLES)]
    return cs, es


def table_indices(curve, n: int) -> np.ndarray:
    """(n, TABLES) indices, no two rows alike."""
    rng = np.random.default_rng(zlib.crc32(_label(curve, n).encode()))
    idx = rng.integers(0, TABLE_SIZE, size=(n, TABLES), dtype=np.int64)
    while True:
        key = (idx[:, 0] << 36) | (idx[:, 1] << 24) | (idx[:, 2] << 12) | idx[:, 3]
        _, first = np.unique(key, return_index=True)
        dup = np.setdiff1d(np.arange(n), first)
        if not dup.size:
            return idx.astype(np.uint16)
        idx[dup] = rng.integers(0, TABLE_SIZE, size=(dup.size, TABLES))


def make_tables(curve, cs, es) -> list[list[tuple[int, int]]]:
    """t_j[v] = (c_j + v e_j) G, affine."""
    tables = []
    for c, e in zip(cs, es):
        step = curve.to_affine(mul(curve, e, curve.gen))
        acc = mul(curve, c, curve.gen)
        pts = [acc]
        for _ in range(TABLE_SIZE - 1):
            acc = curve.madd(acc, *step)
            pts.append(acc)
        tables.append(curve.normalize(pts))
    return tables


def sum_rows(curve_name: str, tables, idx: np.ndarray) -> np.ndarray:
    """The affine sums of each row's table points, as wire words; every
    point is checked to lie on the curve."""
    curve = curves.get(curve_name)
    t0, *rest = tables
    sums = []
    for row in idx.tolist():
        acc = curve.lift(t0[row[0]])
        for table, v in zip(rest, row[1:]):
            acc = curve.madd(acc, *table[v])
        sums.append(acc)
    affine = curve.normalize(sums)
    cb = curve.coord_bytes
    for pt in affine:
        if not curve.on_curve(pt):
            raise ArithmeticError(f"a base is off the curve: {pt}")
    raw = b"".join(x.to_bytes(cb, "little") + y.to_bytes(cb, "little")
                   for x, y in affine)
    return np.frombuffer(raw, dtype=np.uint32).reshape(len(affine), cb // 2)


def make(curve, n: int, workers: int | None = None) -> Bases:
    cs, es = table_logs(curve, n)
    idx = table_indices(curve, n)
    tables = make_tables(curve, cs, es)
    chunks = [idx[lo:lo + CHUNK] for lo in range(0, n, CHUNK)]
    workers = min(workers or os.cpu_count() or 1, len(chunks))
    if workers <= 1:
        parts = [sum_rows(curve.name, tables, ch) for ch in chunks]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            parts = list(pool.map(sum_rows, [curve.name] * len(chunks),
                                  [tables] * len(chunks), chunks))
    return Bases(curve, np.ascontiguousarray(np.concatenate(parts)), idx, cs, es)


def load(curve_name: str, n: int, cache: Path | None = CACHE) -> Bases:
    """The bases from the cache, made and kept there where it lacks them
    (cache None: made, not kept)."""
    curve = curves.get(curve_name)
    path = cache and Path(cache) / f"{curve.name}-{n}-{SCHEME}.npz"
    if path and path.exists():
        with np.load(path) as blob:
            cs, es = table_logs(curve, n)
            return Bases(curve, blob["wire"], blob["idx"], cs, es)
    bases = make(curve, n)
    if path:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.tmp{os.getpid()}.npz")
        np.savez(tmp, wire=bases.wire, idx=bases.idx)
        os.replace(tmp, path)
    return bases
