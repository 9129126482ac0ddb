"""One MSM a call through the port's public entry that the configuration
names (compute_msm, compute_msm_edwards): a new engine a call, as a user
of that entry gets."""

from __future__ import annotations


class Caller:
    def __init__(self, config: dict, points: bytes, pool: list[bytes],
                 device=None):
        import webgpu_msm_bls12_377_tpu_torch as port

        self.fn = getattr(port, config["entry"])
        self.points, self.pool, self.device = points, pool, device

    def call(self, sets: list[int]) -> list[tuple[int, int]]:
        (s,) = sets
        r = self.fn(self.points, self.pool[s], device=self.device)
        return [(r["x"], r["y"])]
