"""PyTorch and CUDA port of the MSM engines for BLS12-377 G1 and Twisted
Edwards BLS12: on either curve, the cuZK engine's tree (hybrid and pure),
stream, fused and legacy paths and its batch mode over a fixed point set
(also over a pool of devices), the Pippenger and naive baseline engines,
and (parallel/) the sharded engine over a mesh of devices and processes;
and (native/) an independent host C++ oracle that checks a sum of points.

multi_scalar_mult_init and multi_scalar_mult keep a fixed point set on the
device across calls, for batches of scalar sets over it, on either curve
and every path; the JAX package has no such entry, so they are the port's
own exports.

The JAX package webgpu_msm_bls12_377_tpu is the reference this port is
tested against; the port imports nothing of it and no JAX.  Kernels are
hand-written CUDA C++ for sm_90a (csrc/), built at first launch.

The reference's MontParams and compute_misc_params are not exported: they
describe its w-bit limbs (nsafe, Barrett constants), which the port's
32-bit words do not use; params.py keeps the port's own MontParams under
that module's name only.
"""

from .api import (
    compute_msm,
    compute_msm_edwards,
    multi_scalar_mult,
    multi_scalar_mult_init,
)
from .params import BLS12_377_BASE_FIELD, EDWARDS_BLS12_BASE_FIELD, CurveId

__all__ = [
    "BLS12_377_BASE_FIELD",
    "EDWARDS_BLS12_BASE_FIELD",
    "CurveId",
    "compute_msm",
    "compute_msm_edwards",
    "multi_scalar_mult",
    "multi_scalar_mult_init",
]
