"""Signed scalar window decomposition.

Each 256-bit scalar (8 LE u32 words) is split into windows of chunk_size
bits; each window digit d is recentred to [-2^(s-1), 2^(s-1)) with a carry
into the next window, and stored shifted by +2^(s-1).  The carry loop runs
over the (few) windows and is vectorized over the scalars.  The final
carry is zero for scalars below 2^253 (the engine validates that).
"""

from __future__ import annotations

import torch

SCALAR_BITS = 256  # 8 LE u32 words per scalar, the wire format
SCALAR_EFF_BITS = 253  # canonical wire scalars are < 2^253 (validated)


def num_windows_for(chunk_size: int) -> int:
    """Windows needed to cover a 253-bit scalar at this chunk size.

    k = ceil(253/c) windows suffice unless the top window's real bit
    count r = 253 - c*(k-1) admits a signed-carry overflow (r >= c-1), in
    which case one carry window is kept: c=16 keeps 16 windows, c=15
    needs 17."""
    k = -(-SCALAR_EFF_BITS // chunk_size)
    r = SCALAR_EFF_BITS - chunk_size * (k - 1)
    return k + (1 if r >= chunk_size - 1 else 0)


def choose_chunk_size(input_size: int) -> int:
    """Window size policy of the JAX package, unchanged: 16 from 2^20,
    15 from 2^16, else 4."""
    if input_size >= 1 << 20:
        return 16
    if input_size >= 1 << 16:
        return 15
    return 4


def decompose_scalars_signed(
    scalar_words: torch.Tensor, chunk_size: int, num_windows: int
) -> torch.Tensor:
    """(8, N) LE u32 scalar words (any integer dtype holding the u32
    values) -> (num_windows, N) int32 stored signed digits in
    [0, 2^chunk_size), window-major."""
    w = scalar_words.to(torch.int64) & 0xFFFFFFFF
    num_u32 = w.shape[0]
    mask = (1 << chunk_size) - 1
    l = 1 << chunk_size
    shift = 1 << (chunk_size - 1)
    carry = torch.zeros_like(w[0])
    rows = []
    for k in range(num_windows):
        a, off = divmod(k * chunk_size, 32)
        v = w[a] >> off
        if off + chunk_size > 32 and a + 1 < num_u32:
            v = v | (w[a + 1] << (32 - off))
        v = (v & mask) + carry
        ge = v >= shift
        # stored = (v - l) + shift on carry lanes, v + shift otherwise
        rows.append(torch.where(ge, v - l + shift, v + shift))
        carry = ge.to(torch.int64)
    return torch.stack(rows).to(torch.int32)
