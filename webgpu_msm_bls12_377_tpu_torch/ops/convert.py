"""Wire words: their two layouts, the repack to field words, and the host
packing.

Wire coordinates are little-endian 32-bit words: 12 per BLS12-377
coordinate, 8 per Edwards BLS12 coordinate, 8 per scalar.  The port's
field elements are 13 and 9 such words (params.py), so the repack of the
JAX package's limbs_from_u32_words becomes "append one zero word" (the
point prep, ops/kernels.py:point_prep, keeps that word in registers).
Words come word-major (the packers' (2, k, N) and (8, N) arrays) or
point-major (a wire buffer's (N, 2k) and (N, 8) words, as they arrive);
WireLayout says which, and gives N.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..params import CurveId
from .field import NW, field_ctx, ints_to_plane

JAX_WORD_BITS = 13
#: 13-bit limbs per field element in the JAX package: BLS12-377 30
#: (R = 2^390), Edwards BLS12 20 (R = 2^260)
JAX_NUM_WORDS = {CurveId.BLS12_377: 30, CurveId.EDWARDS_BLS12: 20}


class WireLayout(NamedTuple):
    """n values of `coords` coordinates of k 32-bit words each, held
    word-major ((coords, k, n), or (k, n) for one coordinate: word i of
    every value in a row) or point-major ((n, coords * k): a value's
    words together, as a wire buffer holds them)."""

    point_major: bool
    n: int
    k: int
    coords: int = 1

    @classmethod
    def of(cls, words, point_major: bool, k: int, coords: int = 1):
        """The layout of a C-contiguous word array, its shape checked."""
        shape = tuple(words.shape)
        n = shape[0] if point_major else shape[-1]
        layout = cls(point_major, n, k, coords)
        if shape != layout.shape:
            raise ValueError(f"expected {'point' if point_major else 'word'}"
                             f"-major words of shape {layout.shape}, got "
                             f"{shape}")
        return layout

    @property
    def shape(self) -> tuple[int, ...]:
        if self.point_major:
            return (self.n, self.coords * self.k)
        return (self.k, self.n) if self.coords == 1 else (
            self.coords, self.k, self.n)

    def strides(self) -> tuple[int, int, int]:
        """(coordinate, word, value) strides of a C-contiguous array, in
        words."""
        if self.point_major:
            return self.k, 1, self.coords * self.k
        return self.k * self.n, self.n, 1

    def word(self, words, coord: int, i: int):
        """Word i of coordinate `coord` of every value: an (n,) view."""
        if self.point_major:
            return words[:, coord * self.k + i]
        return words[i] if self.coords == 1 else words[coord, i]

    def word_major(self, words: torch.Tensor) -> torch.Tensor:
        """The (coords, k, n) word-major form of a tensor of this layout
        (a copy from point-major words)."""
        if self.point_major:
            return words.reshape(self.n, self.coords, self.k).permute(
                1, 2, 0).contiguous()
        return words.reshape(self.coords, self.k, self.n)


def limbs_from_u32_words(words: torch.Tensor, nw: int = NW) -> torch.Tensor:
    """(..., k, N) LE u32 words (k <= nw, held as int32) -> (..., nw, N)."""
    k = words.shape[-2]
    pad = torch.zeros(
        (*words.shape[:-2], nw - k, words.shape[-1]),
        dtype=torch.int32, device=words.device,
    )
    return torch.cat([words.to(torch.int32), pad], dim=-2)


def from_jax_limbs(arr, montgomery: bool,
                   curve: CurveId = CurveId.BLS12_377) -> torch.Tensor:
    """A JAX-package plane of 13-bit limbs (30 per BLS12-377 element, 20
    per Edwards element) -> the port's canonical plane (13 or 9 words).

    arr: (k*w, N) unsigned limbs (soft limbs allowed), k field elements
    stacked per column.  Values are reduced mod p; a Montgomery value
    x*2^(13 w) becomes x*R (R = 2^416 or 2^288).  Returns a (k*nw, N)
    int32 plane on the CPU.
    """
    ctx = field_ctx(curve)
    w, p = JAX_NUM_WORDS[curve], ctx.p
    # R_port / R_jax: a JAX Montgomery value times this (mod p) is the
    # port's
    to_port = pow(2, 32 * ctx.nw - JAX_WORD_BITS * w, p)
    a = np.asarray(arr).astype(np.uint64)
    k = a.shape[0] // w
    if a.shape[0] != k * w:
        raise ValueError(f"rows {a.shape[0]} not a multiple of {w}")
    planes = []
    for c in range(k):
        vals = []
        for j in range(a.shape[1]):
            v = sum(
                int(a[c * w + i, j]) << (JAX_WORD_BITS * i) for i in range(w)
            ) % p
            vals.append(v * to_port % p if montgomery else v)
        planes.append(ints_to_plane(vals, nw=ctx.nw))
    return torch.cat(planes, dim=0)


def from_jax_rows(rows, num_coords: int, montgomery: bool,
                  curve: CurveId = CurveId.BLS12_377) -> torch.Tensor:
    """JAX-package row-major point rows -> the port's row-major words.

    rows: (count, >= num_coords*w) limbs, each row num_coords field
    elements of w limbs and then padding (the fused path's wide rows and
    pre-gathered rows; trailing pad rows are the caller's to cut).  Returns
    (count, num_coords*nw) int32, values reduced mod p as from_jax_limbs."""
    a = np.asarray(rows)[:, : num_coords * JAX_NUM_WORDS[curve]]
    return from_jax_limbs(a.T, montgomery, curve).T.contiguous()


# ---------------------------------------------------------------------------
# Host-side wire packing (numpy; the reference's buffer input format)
# ---------------------------------------------------------------------------


#: rows of a wire array transposed at a time: a block of both layouts
#: stays in cache, where a plain .T copy strides across the whole array
#: (about 4x slower at 2^20 points)
TRANSPOSE_ROWS = 1024


def words_by_row(words: np.ndarray) -> np.ndarray:
    """(N, k) little-endian words, one row per value -> C-contiguous (k, N)
    uint32 array, word i of every value in row i, transposed block by
    block."""
    n, k = words.shape
    out = np.empty((k, n), dtype=np.uint32)
    for i in range(0, n, TRANSPOSE_ROWS):
        out[:, i:i + TRANSPOSE_ROWS] = words[i:i + TRANSPOSE_ROWS].T
    return out


def points_buffer_to_words(buf: bytes, coord_bytes: int) -> np.ndarray:
    """x||y LE byte buffer -> (2, coord_bytes//4, N) uint32 word array,
    C-contiguous (the engine's host-to-device copy reads it in one pass)."""
    per_point = 2 * coord_bytes
    if len(buf) % per_point:
        raise ValueError(f"buffer length {len(buf)} not a multiple of {per_point}")
    n = len(buf) // per_point
    words = np.frombuffer(buf, dtype="<u4").reshape(n, per_point // 4)
    return words_by_row(words).reshape(2, coord_bytes // 4, n)


def scalars_buffer_to_words(buf: bytes) -> np.ndarray:
    """32-byte LE scalars -> (8, N) uint32 word array, C-contiguous."""
    if len(buf) % 32:
        raise ValueError(f"buffer length {len(buf)} not a multiple of 32")
    return words_by_row(np.frombuffer(buf, dtype="<u4").reshape(-1, 8))


def wire_words(buf, value_bytes: int,
               coords: int = 1) -> tuple[np.ndarray, WireLayout]:
    """A little-endian wire buffer of values of `coords` coordinates of
    value_bytes bytes each (points: x||y, 48 or 32 bytes a coordinate;
    scalars: 32 bytes) -> its point-major (N, coords * value_bytes / 4)
    uint32 words, a view of the buffer in the order it holds them, and
    their layout."""
    per_value, nbytes = coords * value_bytes, memoryview(buf).nbytes
    if nbytes % per_value:
        raise ValueError(f"buffer length {nbytes} not a multiple of "
                         f"{per_value}")
    words = np.frombuffer(buf, dtype="<u4").reshape(-1, per_value // 4)
    return words, WireLayout.of(words, True, value_bytes // 4, coords)


def ints_to_words(vals, num_u32: int) -> np.ndarray:
    """Python ints (each < 2^(32*num_u32)) -> (num_u32, N) LE uint32 array,
    C-contiguous."""
    buf = b"".join(int(v).to_bytes(4 * num_u32, "little") for v in vals)
    return words_by_row(
        np.frombuffer(buf, dtype="<u4").reshape(len(vals), num_u32))
