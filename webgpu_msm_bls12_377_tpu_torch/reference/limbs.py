"""Little-endian word helpers for the bigint oracles."""

from __future__ import annotations

from typing import Sequence


def to_words_le(val: int, num_words: int, word_size: int) -> list[int]:
    """Little-endian fixed-width word decomposition of a non-negative int."""
    mask = (1 << word_size) - 1
    return [(val >> (i * word_size)) & mask for i in range(num_words)]


def from_words_le_unchecked(words: Sequence[int], word_size: int) -> int:
    """Sum of words[i] << (i * word_size); words may exceed word_size bits."""
    val = 0
    for i, w in enumerate(words):
        val += int(w) << (i * word_size)
    return val
