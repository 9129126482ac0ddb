"""The plain reference: the MSM of a scalar set over the fixed bases, with
NumPy and Python integers, from the bases' known logarithms.

sum_i s_i P_i = (sum_i s_i k_i mod order) G, and k_i = sum_j (c_j +
idx_ij e_j) (bases.py), so the sum needs sum_i s_i and, for each table j,
sum_i s_i idx_ij.  Those are the products of the scalars' 16-bit limbs
(n x 16) with the columns [1, idx_0 .. idx_3] (n x 5), in float64: every
partial sum is an integer below n 2^16 2^12 <= 2^48, which float64 holds
exactly.  The scalar multiplication of G is double-and-add (curves/).

It imports nothing of the program and reads nothing the program made: the
scalars and the bases are the benchmark's own.
"""

from __future__ import annotations

import numpy as np

from .bases import Bases
from .curves import mul


def log_sum(bases: Bases, words: np.ndarray) -> int:
    """sum_i s_i k_i mod the order, for (n, 8) uint32 scalar words."""
    limbs = np.ascontiguousarray(words).view(np.uint16).astype(np.float64)
    cols = np.empty((bases.n, 1 + bases.idx.shape[1]), dtype=np.float64)
    cols[:, 0] = 1.0
    cols[:, 1:] = bases.idx
    m = limbs.T @ cols
    sums = [sum(int(m[l, j]) << (16 * l) for l in range(m.shape[0]))
            for j in range(m.shape[1])]
    total = sum(bases.cs) * sums[0] + sum(
        e * s for e, s in zip(bases.es, sums[1:]))
    return total % bases.curve.order


def msm(bases: Bases, words: np.ndarray) -> tuple[int, int]:
    """The affine result ((0, 1) for the identity)."""
    curve = bases.curve
    return curve.to_affine(mul(curve, log_sum(bases, words), curve.gen))


def check_bases(bases: Bases, picks) -> list[int]:
    """The picked bases that are not k_i G (an empty list where all are)."""
    curve = bases.curve
    return [i for i in picks
            if bases.point(i) != curve.to_affine(mul(curve, bases.log(i),
                                                     curve.gen))]
