"""PyTorch and CUDA port of the MSM engine (BLS12-377 G1, hybrid tree).

The JAX package webgpu_msm_bls12_377_tpu is the reference this port is
tested against; the port imports nothing of it and no JAX.  Kernels are
hand-written CUDA C++ for sm_90a (csrc/), built at first launch.
"""

from .api import compute_msm
from .params import CurveId

__all__ = ["compute_msm", "CurveId"]
