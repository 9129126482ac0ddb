"""The cuZK MSM engine, hybrid-tree path, for BLS12-377 G1.

compute_msm(points, scalars) -> {"x": int, "y": int} runs, on one device:
  1. point prep: wire words -> Montgomery table (kernel 1);
  2. plan: signed window digits -> stable per-window sort -> bucket
     segments -> phantom-extended hybrid plan (plain PyTorch);
  3. SMVP: tree levels 1..K (kernel 2), then the packed finish (kernel 3);
  4. permute_buckets in BPR walk order, then BPR (kernel 4 launches);
  5. Montgomery exit (kernel 1) and one readback of num_windows points;
  6. Horner across windows on the host, with Python integers.
PyTorch runs eagerly, so the JAX package's plan/main program split, its
size classes and their host readback, and its compile caches have no
counterpart here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops import field as F
from ..ops.bpr import bpr_order, reduce_buckets_prearranged
from ..ops.buckets import build_bucket_plan
from ..ops.convert import (
    ints_to_words,
    points_buffer_to_words,
    scalars_buffer_to_words,
    u32_words_to_limbs_mont,
)
from ..ops.decompose import (
    SCALAR_BITS,
    choose_chunk_size,
    decompose_scalars_signed,
    num_windows_for,
)
from ..ops.kernels import mont_mul_const
from ..ops.smvp_stream import permute_buckets
from ..ops.smvp_tree import build_hybrid_plan, build_tree_table, tree_smvp_hybrid
from ..params import CurveId
from ..reference import curve as ocurve
from ..reference import msm as omsm

#: n from which "auto" takes the hybrid tree (the JAX package's static
#: policy, models/cuzk.py:_select_smvp)
TREE_MIN_N = 1 << 18
COORD_BYTES = 48


def resolve_device(device) -> torch.device:
    """None means the first CUDA device; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the engine runs on the GPU unless it is given "
            "device='cpu'"
        )
    return dev


def words_to_device(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 host word array -> int32 tensor of the same bits on device."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(device)


def mont_point_table(point_words: torch.Tensor) -> torch.Tensor:
    """(2, 12, N) wire words -> (26, N) Montgomery (x; y) plane."""
    return u32_words_to_limbs_mont(point_words)


class CuzkMsmEngine:
    """End-to-end MSM engine for BLS12-377 G1 on one device."""

    def __init__(
        self,
        curve: CurveId = CurveId.BLS12_377,
        *,
        chunk_size: int | None = None,
        num_bpr_threads: int = 512,
        tree_finish: int = 2,  # K, the static hybrid finish level
        smvp_mode: str = "auto",
        device=None,
    ):
        """smvp_mode "auto" runs the hybrid tree from n = 2^18 and raises
        below; "tree" runs the hybrid tree at any n (tests at small n)."""
        if curve != CurveId.BLS12_377:
            raise NotImplementedError(
                "the port runs BLS12-377 G1 only; Edwards is ROADMAP item 1.9"
            )
        if num_bpr_threads < 1 or num_bpr_threads & (num_bpr_threads - 1):
            raise ValueError(
                f"num_bpr_threads must be a power of two, got {num_bpr_threads}"
            )
        if tree_finish < 1:
            raise ValueError(f"tree_finish must be >= 1, got {tree_finish}")
        if smvp_mode not in ("auto", "tree"):
            raise ValueError(f"unknown smvp_mode {smvp_mode!r}")
        self.curve = curve
        self.chunk_size_override = chunk_size
        self.num_bpr_threads = num_bpr_threads
        self.tree_finish = tree_finish
        self.smvp_mode = smvp_mode
        self.device = resolve_device(device)

    def _select_smvp(self, n: int) -> str:
        if self.smvp_mode == "auto" and n < TREE_MIN_N:
            raise NotImplementedError(
                f"n = {n} < 2^18 takes the stream path, not yet ported "
                "(ROADMAP item 1.11); smvp_mode='tree' forces the hybrid"
            )
        return "tree"

    def _chunk_for(self, n: int) -> int:
        return self.chunk_size_override or choose_chunk_size(n)

    # -- input normalization (reference wire formats) -----------------------

    @staticmethod
    def _prepare_points(points: Any) -> np.ndarray:
        if isinstance(points, (bytes, bytearray, memoryview)):
            return points_buffer_to_words(bytes(points), COORD_BYTES)
        if isinstance(points, np.ndarray) and points.dtype == np.uint32:
            return points  # already (2, 12, N)
        num_u32 = COORD_BYTES // 4
        xs = ints_to_words([p[0] for p in points], num_u32)
        ys = ints_to_words([p[1] for p in points], num_u32)
        return np.stack([xs, ys])

    @staticmethod
    def _prepare_scalars(scalars: Any) -> np.ndarray:
        if isinstance(scalars, (bytes, bytearray, memoryview)):
            return scalars_buffer_to_words(bytes(scalars))
        if isinstance(scalars, np.ndarray) and scalars.dtype == np.uint32:
            return scalars
        return ints_to_words(list(scalars), SCALAR_BITS // 32)

    @staticmethod
    def _validate(n: int, scalar_words: np.ndarray) -> None:
        if scalar_words.shape[-1] != n:
            raise ValueError(
                f"point/scalar count mismatch: {n} vs {scalar_words.shape[-1]}"
            )
        if n == 0:
            raise ValueError("empty MSM")
        # the signed decomposition's final carry is zero only below 2^253
        if bool((scalar_words[7] >> 29).any()):
            raise ValueError("scalars must be < 2^253")

    # -- device pipeline ------------------------------------------------------

    def msm_device(
        self, point_words: np.ndarray, scalar_words: np.ndarray, chunk_size: int
    ) -> torch.Tensor:
        """The device pipeline: returns the (39, num_windows) canonical
        window sums in plain (non-Montgomery) form, on the device."""
        n = point_words.shape[-1]
        self._select_smvp(n)
        num_windows = num_windows_for(chunk_size)
        pw = words_to_device(point_words, self.device)
        sw = words_to_device(scalar_words, self.device)
        table = mont_point_table(pw)
        digits = decompose_scalars_signed(sw, chunk_size, num_windows)
        plan = build_bucket_plan(digits, chunk_size)
        kn = plan.sorted_vals.shape[0]
        tplan = build_hybrid_plan(
            plan.starts, plan.lens, kn, self.tree_finish, num_windows
        )
        blocks = tree_smvp_hybrid(
            build_tree_table(table), plan.sorted_vals, tplan, self.tree_finish
        )
        order = bpr_order(num_windows, chunk_size, self.num_bpr_threads)
        buckets = permute_buckets(blocks, tplan.layout, order=order)
        wsums = reduce_buckets_prearranged(
            buckets, num_windows, chunk_size, self.num_bpr_threads
        )
        return mont_mul_const(wsums, 1)

    def _finalize(self, coords: torch.Tensor, chunk_size: int) -> dict[str, int]:
        cols = [F.plane_to_ints(coords[c * F.NW : (c + 1) * F.NW])
                for c in range(3)]
        window_pts = [ocurve.ProjectivePoint(*v) for v in zip(*cols)]
        result = omsm.horner(window_pts, chunk_size, omsm.G1)
        x, y = ocurve.g1_to_affine(result)
        return {"x": x, "y": y}

    def compute_msm(self, points: Any, scalars: Any) -> dict[str, int]:
        point_words = self._prepare_points(points)
        scalar_words = self._prepare_scalars(scalars)
        n = point_words.shape[-1]
        self._validate(n, scalar_words)
        chunk_size = self._chunk_for(n)
        coords = self.msm_device(point_words, scalar_words, chunk_size)
        return self._finalize(coords, chunk_size)
