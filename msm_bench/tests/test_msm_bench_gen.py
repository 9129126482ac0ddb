"""The scalar generators: the same seed gives the same sets, every scalar
lies below 2^253, and zipf's rank counts are exact."""

import numpy as np
import pytest

from msm_bench.gen import uniform, zipf

CONFIG = {"scalar_bits": 253}
SEEDS = [0, 7, 2**31 + 3, 2**40 + 1, -5]


def words_to_ints(w):
    return [int.from_bytes(row.tobytes(), "little") for row in w]


@pytest.mark.parametrize("gen,traffic", [
    (uniform, {"n": 4096, "pool_sets": 3}),
    (zipf, {"n": 4096, "pool_sets": 3, "pool_bits": 8, "alpha": 1.2}),
])
@pytest.mark.parametrize("seed", SEEDS)
def test_deterministic_and_bounded(gen, traffic, seed):
    a = gen.scalar_sets(traffic, CONFIG, seed)
    b = gen.scalar_sets(traffic, CONFIG, seed)
    other = gen.scalar_sets(traffic, CONFIG, seed + 1)
    assert len(a) == traffic["pool_sets"]
    for x, y, z in zip(a, b, other):
        assert x.shape == (traffic["n"], 8) and x.dtype == np.uint32
        assert x.flags["C_CONTIGUOUS"]
        assert np.array_equal(x, y)
        assert not np.array_equal(x, z)
        assert max(words_to_ints(x)) < 1 << 253
    assert not np.array_equal(a[0], a[1])


def test_uniform_reaches_the_top_bit():
    (w,) = uniform.scalar_sets({"n": 4096, "pool_sets": 1}, CONFIG, 1)
    assert (w[:, 7] >> 28).any()  # bit 252 is set in some scalars


def test_zipf_rank_counts():
    n, bits, alpha = 262144, 8, 1.2
    counts = zipf.rank_counts(n, bits, alpha)
    weights = np.array([1 / (r + 1) ** alpha for r in range(1 << bits)])
    weights /= weights.sum()
    assert counts.sum() == n
    assert np.all(np.abs(counts - n * weights) < 1)
    assert np.all(np.diff(counts) <= 0)
    traffic = {"n": n, "pool_sets": 2, "pool_bits": bits, "alpha": alpha}
    for seed in (3, 2**31 + 9):
        for w in zipf.scalar_sets(traffic, CONFIG, seed):
            _, seen = np.unique(w, axis=0, return_counts=True)
            assert np.array_equal(np.sort(seen)[::-1], counts[counts > 0])
