"""The roofline yardstick: the least time an MSM's work can take on the
card, counted from the cell's inputs alone, never from the engine's window
size, path or kernels, so that it reads the same work whatever computes
it.

- Bytes: each point and each scalar read once, each result written once
  (a batch reads its points once for all its sets).
- Additions: those a signed-digit bucket method needs on these very
  scalars, at a window width c fixed from n alone (window_width).  For
  each window: its nonzero digits less its nonempty buckets (a bucket of
  m points takes m - 1 additions), plus 2 (h - 1) for its running-sum
  reduction over h = 2^(c-1) buckets; then (W - 1) (c + 1) to join the W
  windows (c doublings and one addition each).
- Word products: additions times the configuration's
  `word_products_per_add` (configs/*.json says how it is counted).
- Least time: max(bytes / peak bytes/s, word products / peak word
  products/s), the card's row of peaks.json.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def num_windows(bits: int, c: int) -> int:
    """Signed c-bit windows over `bits`-bit scalars: one more where the
    top window's carry can leave it."""
    w = -(-bits // c)
    top_bits = bits - c * (w - 1)
    return w + (top_bits >= c - 1)


def model_adds(n: int, bits: int, c: int) -> int:
    """The count with every digit nonzero and min(n, h) buckets filled."""
    h = 1 << (c - 1)
    w = num_windows(bits, c)
    return w * (n - min(n, h) + 2 * (h - 1)) + (w - 1) * (c + 1)


def window_width(n: int, bits: int) -> int:
    """The width whose model count is least (the smaller on a tie)."""
    return min(range(2, 25), key=lambda c: (model_adds(n, bits, c), c))


def signed_digits(words: np.ndarray, bits: int, c: int):
    """Each window's digits in [-h, h] of (n, 8) uint32 scalar words."""
    padded = np.zeros((words.shape[0], 10), dtype=np.uint64)
    padded[:, :8] = words
    carry = np.zeros(words.shape[0], dtype=np.int64)
    h = 1 << (c - 1)
    for w in range(num_windows(bits, c)):
        bit = w * c
        lo = bit // 32
        both = padded[:, lo] | (padded[:, lo + 1] << np.uint64(32))
        d = ((both >> np.uint64(bit % 32)) & np.uint64((1 << c) - 1)).astype(
            np.int64) + carry
        carry = (d >= h).astype(np.int64)
        yield d - (carry << c)


def adds(words: np.ndarray, bits: int, c: int) -> int:
    """The yardstick's additions for one MSM of these scalars."""
    h = 1 << (c - 1)
    total = 0
    windows = 0
    for d in signed_digits(words, bits, c):
        mag = np.abs(d)
        filled = np.bincount(mag, minlength=h + 1)[1:]
        total += int(filled.sum()) - int(np.count_nonzero(filled)) + 2 * (h - 1)
        windows += 1
    return total + (windows - 1) * (c + 1)


def peaks_for(device_name: str) -> dict | None:
    """The peaks.json row whose key the card's name contains."""
    for key, row in json.loads(PEAKS.read_text()).items():
        if key in device_name:
            return row
    return None


def least_seconds(config: dict, peaks: dict, n: int, sets_per_call: int,
                  set_adds: int) -> float:
    """The least time of one MSM of a call of sets_per_call sets over n
    points, whose scalars need set_adds additions."""
    coord = 2 * config["coord_bytes"]
    call_bytes = n * coord + sets_per_call * (n * config["scalar_bytes"]
                                              + coord)
    return max(call_bytes / sets_per_call / peaks["bytes_per_s"],
               set_adds * config["word_products_per_add"]
               / peaks["word_products_per_s"])
