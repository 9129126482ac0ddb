"""Point coordinate conversion (wire words -> Montgomery words) and packing.

Wire coordinates are little-endian 32-bit words (12 per BLS12-377
coordinate).  The port's field element is 13 such words (params.py), so
the repack of the JAX package's limbs_from_u32_words becomes "append one
zero word", and the Montgomery entry is kernel 1 with y = R^2 mod p.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import BLS12_377_PARAMS
from .field import NW, P, ints_to_plane
from .kernels import mont_mul_const

#: R_port / R_jax = 2^416 / 2^390: a JAX Montgomery value x*2^390 times
#: this (mod p) is the port's x*2^416
_JAX_TO_PORT = pow(2, 26, P)
JAX_WORD_BITS = 13
JAX_NUM_WORDS = 30


def limbs_from_u32_words(words: torch.Tensor) -> torch.Tensor:
    """(..., k, N) LE u32 words (k <= 13, held as int32) -> (..., 13, N)."""
    k = words.shape[-2]
    pad = torch.zeros(
        (*words.shape[:-2], NW - k, words.shape[-1]),
        dtype=torch.int32, device=words.device,
    )
    return torch.cat([words.to(torch.int32), pad], dim=-2)


def u32_words_to_limbs_mont(words: torch.Tensor) -> torch.Tensor:
    """(g, k, N) wire words of g coordinates -> (g*13, N) Montgomery plane
    (one kernel-1 launch for all g coordinates)."""
    limbs = limbs_from_u32_words(words)
    return mont_mul_const(limbs.reshape(-1, limbs.shape[-1]), BLS12_377_PARAMS.r2)


def from_jax_limbs(arr, montgomery: bool) -> torch.Tensor:
    """A JAX-package plane of 30 x 13-bit limbs per field element ->
    the port's canonical 13 x 32-bit plane.

    arr: (k*30, N) unsigned limbs (soft limbs allowed), k field elements
    stacked per column.  Values are reduced mod p; a Montgomery value
    x*2^390 becomes x*2^416.  Returns a (k*13, N) int32 plane on the CPU.
    """
    a = np.asarray(arr).astype(np.uint64)
    k = a.shape[0] // JAX_NUM_WORDS
    if a.shape[0] != k * JAX_NUM_WORDS:
        raise ValueError(f"rows {a.shape[0]} not a multiple of {JAX_NUM_WORDS}")
    planes = []
    for c in range(k):
        vals = []
        for j in range(a.shape[1]):
            v = sum(
                int(a[c * JAX_NUM_WORDS + i, j]) << (JAX_WORD_BITS * i)
                for i in range(JAX_NUM_WORDS)
            ) % P
            vals.append(v * _JAX_TO_PORT % P if montgomery else v)
        planes.append(ints_to_plane(vals))
    return torch.cat(planes, dim=0)


def from_jax_rows(rows, num_coords: int, montgomery: bool) -> torch.Tensor:
    """JAX-package row-major point rows -> the port's row-major words.

    rows: (count, >= num_coords*30) limbs, each row num_coords field
    elements of 30 limbs and then padding (the fused path's wide rows and
    pre-gathered rows; trailing pad rows are the caller's to cut).  Returns
    (count, num_coords*13) int32, values reduced mod p as from_jax_limbs."""
    a = np.asarray(rows)[:, : num_coords * JAX_NUM_WORDS]
    return from_jax_limbs(a.T, montgomery).T.contiguous()


# ---------------------------------------------------------------------------
# Host-side wire packing (numpy; the reference's buffer input format)
# ---------------------------------------------------------------------------


def points_buffer_to_words(buf: bytes, coord_bytes: int) -> np.ndarray:
    """x||y LE byte buffer -> (2, coord_bytes//4, N) uint32 word array."""
    per_point = 2 * coord_bytes
    if len(buf) % per_point:
        raise ValueError(f"buffer length {len(buf)} not a multiple of {per_point}")
    n = len(buf) // per_point
    words = np.frombuffer(buf, dtype="<u4").reshape(n, per_point // 4)
    c = coord_bytes // 4
    return np.stack([words[:, :c].T, words[:, c:].T]).astype(np.uint32)


def scalars_buffer_to_words(buf: bytes) -> np.ndarray:
    """32-byte LE scalars -> (8, N) uint32 word array."""
    if len(buf) % 32:
        raise ValueError(f"buffer length {len(buf)} not a multiple of 32")
    return np.frombuffer(buf, dtype="<u4").reshape(-1, 8).T.astype(np.uint32)


def ints_to_words(vals, num_u32: int) -> np.ndarray:
    """Python ints (each < 2^(32*num_u32)) -> (num_u32, N) LE uint32 array."""
    buf = b"".join(int(v).to_bytes(4 * num_u32, "little") for v in vals)
    return (
        np.frombuffer(buf, dtype="<u4").reshape(len(vals), num_u32).T
        .astype(np.uint32)
    )
