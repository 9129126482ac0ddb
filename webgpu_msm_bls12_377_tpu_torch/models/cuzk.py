"""The cuZK MSM engine for BLS12-377 G1: hybrid tree, stream and legacy
SMVP paths.

compute_msm(points, scalars) -> {"x": int, "y": int} runs, on one device:
  1. point prep: wire words -> Montgomery table (kernel 1);
  2. plan: signed window digits -> stable per-window sort -> bucket
     segments (plain PyTorch);
  3. SMVP, by _select_smvp (the JAX engine's policy):
     - "tree" (n >= 2^18): the phantom-extended hybrid plan, tree levels
       1..K (kernel 2), then the packed finish (kernel 3);
     - "stream" (below 2^18, chunk >= 9): the length-sorted layout, then
       kernel 5 over the signed table and the sorted entry stream;
     - "legacy" (otherwise, and PippengerMsmEngine): per window group,
       lockstep rounds of kernel 6, the group's round count read back
       once as the per-window maxima;
  4. BPR (kernel 4): every path gathers its buckets into BPR walk order
     once (tree and stream compose that into their block permute) and
     runs reduce_buckets_prearranged;
  5. Montgomery exit (kernel 1) and one readback of num_windows points;
  6. Horner across windows on the host, with Python integers.
PyTorch runs eagerly, so the JAX package's plan/main program split, its
size classes and their host readbacks, and its compile caches have no
counterpart here; the legacy path's readback stays, since it fixes how
many rounds run.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops import field as F
from ..ops.bpr import bpr_order, reduce_buckets_prearranged
from ..ops.buckets import (
    BucketPlan,
    accumulate_buckets,
    build_bucket_plan,
    round_class,
    window_slice_indices,
)
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
from ..ops.smvp_stream import (
    accumulate_buckets_streamed,
    build_signed_table,
    build_stream_layout,
    permute_buckets,
    stream_supported,
)
from ..ops.smvp_tree import build_hybrid_plan, tree_smvp_hybrid
from ..params import CurveId
from ..reference import curve as ocurve
from ..reference import msm as omsm

#: n from which "auto" takes the hybrid tree (the JAX package's static
#: policy, models/cuzk.py:_select_smvp)
TREE_MIN_N = 1 << 18
COORD_BYTES = 48
SMVP_MODES = ("auto", "tree", "stream", "legacy", "fused")


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
        """smvp_mode "auto" follows the JAX engine's policy (_select_smvp)
        and answers at every n; "tree", "stream" and "legacy" force that
        path at any n and chunk size."""
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
        if smvp_mode not in SMVP_MODES:
            raise ValueError(f"unknown smvp_mode {smvp_mode!r}")
        self.curve = curve
        self.chunk_size_override = chunk_size
        self.num_bpr_threads = num_bpr_threads
        self.tree_finish = tree_finish
        self.smvp_mode = smvp_mode
        self.device = resolve_device(device)

    def _select_smvp(self, chunk_size: int, n: int) -> str:
        """Resolve smvp_mode to the path for this size.  "auto": the hybrid
        tree from n = 2^18; below, the stream path wherever the JAX engine
        takes it on a TPU (stream_supported: chunk_size >= 9), else legacy
        (the JAX engine tries its fused path before legacy; the port has
        none yet).  Explicit "stream" and "legacy" run at any n and chunk
        size: kernel 5 has no lane constraint."""
        mode = self.smvp_mode
        if mode == "fused":
            raise NotImplementedError(
                "the fused (segment-DMA) SMVP path is not ported yet: "
                "ROADMAP section 2, kernel row 10"
            )
        if mode != "auto":
            return mode
        if n >= TREE_MIN_N:
            return "tree"
        return "stream" if stream_supported(chunk_size) else "legacy"

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
        path = self._select_smvp(chunk_size, point_words.shape[-1])
        num_windows = num_windows_for(chunk_size)
        pw = words_to_device(point_words, self.device)
        sw = words_to_device(scalar_words, self.device)
        table = mont_point_table(pw)
        digits = decompose_scalars_signed(sw, chunk_size, num_windows)
        plan = build_bucket_plan(digits, chunk_size)
        smvp = {"tree": self._smvp_tree, "stream": self._smvp_stream,
                "legacy": self._smvp_legacy}[path]
        wsums = smvp(table, plan, chunk_size, num_windows)
        return mont_mul_const(wsums, 1)

    def _reduce_blocks(self, blocks, layout, chunk_size, num_windows):
        """Block-ordered buckets -> window sums: the permute with the BPR
        walk order composed in, then the gather-free BPR."""
        order = bpr_order(num_windows, chunk_size, self.num_bpr_threads)
        buckets = permute_buckets(blocks, layout, order=order)
        return reduce_buckets_prearranged(
            buckets, num_windows, chunk_size, self.num_bpr_threads
        )

    def _smvp_tree(self, table, plan, chunk_size, num_windows):
        kn = plan.sorted_vals.shape[0]
        tplan = build_hybrid_plan(
            plan.starts, plan.lens, kn, self.tree_finish, num_windows
        )
        blocks = tree_smvp_hybrid(
            build_signed_table(table), plan.sorted_vals, tplan, self.tree_finish
        )
        return self._reduce_blocks(blocks, tplan.layout, chunk_size, num_windows)

    def _smvp_stream(self, table, plan, chunk_size, num_windows):
        layout = build_stream_layout(plan.starts, plan.lens, num_windows)
        blocks = accumulate_buckets_streamed(
            build_signed_table(table), plan.sorted_vals, layout
        )
        return self._reduce_blocks(blocks, layout, chunk_size, num_windows)

    @staticmethod
    def _window_groups(wmax) -> dict[int, tuple[int, ...]]:
        """Partition windows by SMVP round class from per-window maxima."""
        groups: dict[int, list[int]] = {}
        for w, m in enumerate(wmax):
            groups.setdefault(round_class(int(m)), []).append(w)
        return {cls: tuple(ws) for cls, ws in groups.items()}

    def _smvp_legacy(self, table, plan, chunk_size, num_windows):
        h = 1 << (chunk_size - 1)
        # the path's one host readback: num_windows maxima pick the rounds
        wmax = plan.lens.reshape(num_windows, h).max(dim=1).values.tolist()
        wsums = torch.empty((3 * F.NW, num_windows), dtype=torch.int32,
                            device=self.device)
        for rounds, windows in sorted(self._window_groups(wmax).items()):
            idx = torch.as_tensor(window_slice_indices(windows, h),
                                  device=self.device)
            plan_g = BucketPlan(plan.sorted_vals, plan.starts[idx], plan.lens[idx])
            buckets = accumulate_buckets(table, plan_g, rounds)
            order = torch.as_tensor(
                bpr_order(len(windows), chunk_size, self.num_bpr_threads),
                device=self.device,
            ).reshape(-1).to(torch.int64)
            wsums[:, list(windows)] = reduce_buckets_prearranged(
                buckets[:, order], len(windows), chunk_size, self.num_bpr_threads
            )
        return wsums

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
