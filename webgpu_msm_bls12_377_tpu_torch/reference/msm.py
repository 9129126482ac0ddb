"""CPU MSM oracles: the naive sum and the Horner fold across windows."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

from . import curve as crv


@dataclass(frozen=True)
class Group:
    """Abstract group ops used by the generic MSM models."""

    zero: Any
    add: Callable[[Any, Any], Any]
    neg: Callable[[Any], Any]
    scalar_mult: Callable[[Any, int], Any]
    eq: Callable[[Any, Any], bool]


G1 = Group(
    zero=crv.G1_ZERO,
    add=crv.g1_add,
    neg=crv.g1_neg,
    scalar_mult=crv.g1_scalar_mult,
    eq=crv.g1_eq,
)

EDWARDS = Group(
    zero=crv.ED_ZERO,
    add=crv.ed_add,
    neg=crv.ed_neg,
    scalar_mult=crv.ed_scalar_mult,
    eq=crv.ed_eq,
)


def naive_msm(points: Sequence[Any], scalars: Sequence[int], group: Group = G1):
    """Ground-truth sum of k_i * P_i."""
    acc = group.zero
    for pt, k in zip(points, scalars):
        acc = group.add(acc, group.scalar_mult(pt, k))
    return acc


def horner(window_sums: Sequence[Any], chunk_size: int, group: Group = G1):
    """Fold window sums: sum_w 2^(chunk_size * w) * window_sums[w]."""
    m = 1 << chunk_size
    result = window_sums[-1]
    for i in range(len(window_sums) - 2, -1, -1):
        result = group.scalar_mult(result, m)
        result = group.add(result, window_sums[i])
    return result
