"""Public MSM entry points: BLS12-377 G1 and Twisted Edwards BLS12 on the
GPU.

compute_msm(points, scalars) -> {"x": int, "y": int}.  points: a
sequence of affine (x, y) int pairs, a bytes buffer of x||y little-endian
48-byte coordinates (96 bytes per point), or a (2, 12, N) uint32 word
array; scalars: a sequence of ints < 2^253, a bytes buffer of 32-byte LE
scalars, or an (8, N) uint32 word array.  compute_msm_edwards takes the
same forms with 32-byte coordinates (64 bytes per point; words (2, 8, N)).
"""

from __future__ import annotations

from typing import Any


def compute_msm(points: Any, scalars: Any, device=None) -> dict[str, int]:
    """BLS12-377 G1 MSM on ``device``: None means the first CUDA device,
    and raises where there is none; pass device="cpu" for the plain
    PyTorch forms of every kernel."""
    from .models.cuzk import CuzkMsmEngine

    return CuzkMsmEngine(device=device).compute_msm(points, scalars)


def compute_msm_edwards(points: Any, scalars: Any, device=None) -> dict[str, int]:
    """Twisted Edwards BLS12 MSM, as compute_msm, with the same policy:
    the fused path below 2^16 (chunk 4), the stream path from 2^16 and the
    hybrid tree from 2^18."""
    from .models.cuzk import CuzkMsmEngine
    from .params import CurveId

    engine = CuzkMsmEngine(CurveId.EDWARDS_BLS12, device=device)
    return engine.compute_msm(points, scalars)
