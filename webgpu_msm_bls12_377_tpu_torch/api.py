"""Public MSM entry point: BLS12-377 G1 on the GPU.

compute_msm(points, scalars) -> {"x": int, "y": int}.  points: a
sequence of affine (x, y) int pairs, a bytes buffer of x||y little-endian
48-byte coordinates (96 bytes per point), or a (2, 12, N) uint32 word
array; scalars: a sequence of ints < 2^253, a bytes buffer of 32-byte LE
scalars, or an (8, N) uint32 word array.
"""

from __future__ import annotations

from typing import Any


def compute_msm(points: Any, scalars: Any, device=None) -> dict[str, int]:
    """BLS12-377 G1 MSM on ``device``: None means the first CUDA device,
    and raises where there is none; pass device="cpu" for the plain
    PyTorch forms of every kernel."""
    from .models.cuzk import CuzkMsmEngine

    return CuzkMsmEngine(device=device).compute_msm(points, scalars)
