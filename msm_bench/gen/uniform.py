"""Uniform scalars: `pool_sets` sets of n scalars, each uniform below
2^scalar_bits, as (n, 8) uint32 words in wire order (32-byte little-endian
scalars)."""

from __future__ import annotations

import numpy as np

from ..cell import rng


def top_mask(bits: int) -> np.uint32:
    """The mask of the top (eighth) word's bits below 2^bits."""
    return np.uint32((1 << (bits - 224)) - 1)


def scalar_sets(traffic: dict, config: dict, seed: int) -> list[np.ndarray]:
    gen = rng(seed, "uniform")
    out = []
    for _ in range(traffic["pool_sets"]):
        words = gen.integers(0, 1 << 32, size=(traffic["n"], 8), dtype=np.uint32)
        words[:, 7] &= top_mask(config["scalar_bits"])
        out.append(words)
    return out
