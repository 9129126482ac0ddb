"""Windowed bucket-method (Pippenger) MSM engine.

The classic method is the legacy path of CuzkMsmEngine: signed digit
decomposition, bucket accumulation (ops/buckets.py:legacy_buckets, kernel
6: every bucket's sum in one launch, the TPU's masked lockstep rounds
walked by one thread a bucket, or a piece of one), running-sum bucket
reduction (ops/bpr.py:reduce_buckets_prearranged) and the host Horner
walk.  This class pins that configuration under its name, as the JAX
package's models/pippenger.py does.
"""

from __future__ import annotations

from ..params import CurveId
from .cuzk import CuzkMsmEngine


class PippengerMsmEngine(CuzkMsmEngine):
    """CuzkMsmEngine pinned to smvp_mode="legacy", for either curve; same
    public surface."""

    def __init__(self, curve: CurveId = CurveId.BLS12_377, **kwargs):
        kwargs.setdefault("smvp_mode", "legacy")
        if kwargs["smvp_mode"] != "legacy":
            raise ValueError(
                "PippengerMsmEngine is the legacy bucket method; "
                f"smvp_mode={kwargs['smvp_mode']!r} is not it"
            )
        super().__init__(curve, **kwargs)
