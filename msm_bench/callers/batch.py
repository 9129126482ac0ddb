"""Scalar sets over the fixed bases through one CuzkMsmEngine held from
set-up (compute_msm_batch): a prover committing to several polynomials
over one key.  Each call hands over the bases' wire bytes and the sets'."""

from __future__ import annotations


class Caller:
    def __init__(self, config: dict, points: bytes, pool: list[bytes],
                 device=None):
        from webgpu_msm_bls12_377_tpu_torch.models import CuzkMsmEngine
        from webgpu_msm_bls12_377_tpu_torch.params import CurveId

        self.engine = CuzkMsmEngine(CurveId(config["curve"]), device=device)
        self.points, self.pool = points, pool

    def call(self, sets: list[int]) -> list[tuple[int, int]]:
        out = self.engine.compute_msm_batch(self.points,
                                            [self.pool[s] for s in sets])
        return [(r["x"], r["y"]) for r in out]
