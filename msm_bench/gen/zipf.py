"""Skewed scalars: each set draws its n scalars from a pool of
2^pool_bits full-width values, rank r taken in proportion to
1 / (r + 1)^alpha (the weights of the port's harness/testdata.py
zipf_scalars).  Every set has the same count of each rank, n times its
weight rounded by largest remainders, so every seed does the same amount
of work; the seed draws the pool's values and which scalars take which
rank."""

from __future__ import annotations

import numpy as np

from ..cell import rng
from .uniform import top_mask


def rank_counts(n: int, pool_bits: int, alpha: float) -> np.ndarray:
    size = 1 << pool_bits
    weights = np.array([1.0 / (r + 1) ** alpha for r in range(size)])
    weights /= weights.sum()
    exact = n * weights
    counts = np.floor(exact).astype(np.int64)
    extra = np.argsort(-(exact - counts), kind="stable")[: n - counts.sum()]
    counts[extra] += 1
    return counts


def scalar_sets(traffic: dict, config: dict, seed: int) -> list[np.ndarray]:
    n, bits = traffic["n"], traffic["pool_bits"]
    ranks = np.repeat(np.arange(1 << bits),
                      rank_counts(n, bits, traffic["alpha"]))
    gen = rng(seed, "zipf")
    out = []
    for _ in range(traffic["pool_sets"]):
        pool = gen.integers(0, 1 << 32, size=(1 << bits, 8), dtype=np.uint32)
        pool[:, 7] &= top_mask(config["scalar_bits"])
        out.append(np.ascontiguousarray(pool[gen.permutation(ranks)]))
    return out
