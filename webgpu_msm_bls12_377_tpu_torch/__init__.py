"""PyTorch and CUDA port of the MSM engines (BLS12-377 G1: the cuZK engine's
tree (hybrid and pure), stream, fused and legacy paths and its batch mode
over a fixed point set, Pippenger and the naive baseline).

The JAX package webgpu_msm_bls12_377_tpu is the reference this port is
tested against; the port imports nothing of it and no JAX.  Kernels are
hand-written CUDA C++ for sm_90a (csrc/), built at first launch.
"""

from .api import compute_msm
from .params import CurveId

__all__ = ["compute_msm", "CurveId"]
