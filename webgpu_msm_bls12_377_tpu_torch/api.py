"""Public MSM entry points: BLS12-377 G1 and Twisted Edwards BLS12 on the
GPU.

compute_msm(points, scalars) -> {"x": int, "y": int}.  points: a
sequence of affine (x, y) int pairs, a bytes buffer of x||y little-endian
48-byte coordinates (96 bytes per point), or a (2, 12, N) uint32 word
array; scalars: a sequence of ints < 2^253, a bytes buffer of 32-byte LE
scalars, or an (8, N) uint32 word array.  compute_msm_edwards takes the
same forms with 32-byte coordinates (64 bytes per point; words (2, 8, N)).
Both take the reference's keywords log_result and force_recompile.
"""

from __future__ import annotations

from typing import Any


def _run(curve, points, scalars, log_result, force_recompile, device):
    from .models.cuzk import CuzkMsmEngine
    from .utils import trace

    with trace.span("msm.api"):
        engine = CuzkMsmEngine(curve, device=device,
                               force_recompile=force_recompile)
        result = engine.compute_msm(points, scalars)
    if log_result:
        print(result)
    return result


def compute_msm(
    points: Any,
    scalars: Any,
    *,
    log_result: bool = False,
    force_recompile: bool = False,
    device=None,
) -> dict[str, int]:
    """BLS12-377 G1 MSM on ``device``: None means the first CUDA device,
    and raises where there is none; pass device="cpu" for the plain
    PyTorch forms of every kernel.

    log_result prints the result, as the reference does.  force_recompile
    compiles every kernel library again from csrc/ before the call (nvcc
    is the port's only compile step; kernels.rebuild says how a build in
    use is replaced).  A CPU call launches no kernel, so force_recompile
    compiles nothing there and leaves the built libraries as they are."""
    from .params import CurveId

    return _run(CurveId.BLS12_377, points, scalars, log_result,
                force_recompile, device)


def compute_msm_edwards(
    points: Any,
    scalars: Any,
    *,
    log_result: bool = False,
    force_recompile: bool = False,
    device=None,
) -> dict[str, int]:
    """Twisted Edwards BLS12 MSM, as compute_msm, with the same keywords and
    the same policy: the fused path below 2^16 (chunk 4), the stream path
    from 2^16 and the hybrid tree from 2^18."""
    from .params import CurveId

    return _run(CurveId.EDWARDS_BLS12, points, scalars, log_result,
                force_recompile, device)
