"""The cuZK MSM engine for BLS12-377 G1: tree (hybrid and pure), stream,
fused and legacy SMVP paths, and batch mode over a fixed point set.

compute_msm(points, scalars) -> {"x": int, "y": int} runs, on one device:
  1. point prep: wire words -> Montgomery table (kernel 1), then the form
     the path reads (signed table, wide rows, or the table itself);
  2. plan: signed window digits -> stable per-window sort -> bucket
     segments (plain PyTorch);
  3. SMVP, by _select_smvp (the JAX engine's policy on a TPU):
     - "tree" (n >= 2^18, chunk >= 9): the phantom-extended plan, tree
       levels 1..K (kernel 2), then the packed finish (kernel 3), K =
       tree_finish; with smvp_mode="tree" and no tree_finish, the pure
       tree: every level until each bucket is one node, the level count
       read back once as the longest bucket;
     - "stream" (chunk >= 9 below that): the length-sorted layout, then
       kernel 5 over the signed table and the sorted entry stream;
     - "fused" (where all buckets fill whole 256-lane blocks, e.g. the
       default chunk 4 below 2^16): the sorted rows gathered once, then
       kernel 8 over each bucket's contiguous rows, window by window where
       a window's buckets fill whole blocks, else in one launch;
     - "legacy" (otherwise, and PippengerMsmEngine): per window group,
       lockstep rounds of kernel 6, the group's round count read back
       once as the per-window maxima;
  4. BPR (kernel 4): every path gathers its buckets into BPR walk order
     once (tree and stream compose that into their block permute) and
     runs reduce_buckets_prearranged;
  5. Montgomery exit (kernel 1) and one readback of num_windows points;
  6. Horner across windows on the host, with Python integers.
compute_msm_batch(points, [scalars, ...]) runs step 1 once and steps 2-5
per scalar set without the host waiting for the device between sets, then
reads every set's window sums back in one copy.
PyTorch runs eagerly, so the JAX package's plan/main program split, its
size classes and their host readbacks, and its compile caches have no
counterpart here; the legacy path's readback stays, since it fixes how
many rounds run, and so does the pure tree's.
"""

from __future__ import annotations

import functools
from typing import Any, Sequence

import numpy as np
import torch

from ..ops import field as F
from ..ops.bpr import bpr_order_on, reduce_buckets_prearranged
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
from ..ops.smvp_kernel import (
    accumulate_buckets_fused,
    accumulate_buckets_windowed,
    fused_supported,
    make_wide_rows,
    pregather_signed,
    windowed_supported,
)
from ..ops.smvp_stream import (
    accumulate_buckets_streamed,
    build_signed_table,
    build_stream_layout,
    permute_buckets,
    stream_supported,
)
from ..ops.smvp_tree import (
    build_hybrid_plan,
    build_tree_plan,
    num_levels,
    permute_tree,
    real_bucket_view,
    tree_smvp,
    tree_smvp_hybrid,
)
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


def _device_key(device) -> tuple[str, int]:
    dev = torch.device(device)
    return dev.type, dev.index or 0


def words_to_device(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 host word array -> int32 tensor of the same bits on device.
    To a CUDA device the words are laid out contiguously straight into a
    pinned buffer and the copy is only enqueued: the host does not wait
    for the stream."""
    host = words.view(np.int32)
    if device.type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(host)).to(device)
    staged = torch.empty(host.shape, dtype=torch.int32, pin_memory=True)
    np.copyto(staged.numpy(), host)
    return staged.to(device, non_blocking=True)


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
        tree_finish: int | None = None,  # K, the hybrid finish level
        smvp_mode: str = "auto",
        device=None,
    ):
        """smvp_mode "auto" follows the JAX engine's policy (_select_smvp)
        and answers at every n; "tree", "stream", "fused" and "legacy"
        force that path at any n and chunk size.  tree_finish is K of the
        hybrid tree; None means 2 under "auto" and the pure tree under an
        explicit "tree"."""
        if curve != CurveId.BLS12_377:
            raise NotImplementedError(
                "the port runs BLS12-377 G1 only; Edwards is ROADMAP item 1.9"
            )
        if num_bpr_threads < 1 or num_bpr_threads & (num_bpr_threads - 1):
            raise ValueError(
                f"num_bpr_threads must be a power of two, got {num_bpr_threads}"
            )
        if tree_finish is not None and tree_finish < 1:
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
        """Resolve smvp_mode to the path for this size.  "auto" is the JAX
        engine's policy on a TPU with an empty autotune table: where a
        window's buckets fill whole 256-lane slabs (stream_supported:
        chunk_size >= 9), the hybrid tree from n = 2^18 and the stream path
        below; else the fused path where _fused_ok; else legacy.  An
        explicit mode runs at any n and chunk size: no kernel here has a
        lane constraint."""
        if self.smvp_mode != "auto":
            return self.smvp_mode
        if stream_supported(chunk_size):
            return "tree" if n >= TREE_MIN_N else "stream"
        return "fused" if self._fused_ok(chunk_size, n) else "legacy"

    @staticmethod
    def _fused_ok(chunk_size: int, n: int) -> bool:
        num_windows = num_windows_for(chunk_size)
        num_buckets = num_windows << (chunk_size - 1)
        return windowed_supported(num_buckets, num_windows, n) or fused_supported(
            num_buckets, num_windows * n
        )

    def _tree_k(self, batch: bool = False) -> int | None:
        """The hybrid finish level K, or None for the pure tree: an
        explicit tree_finish wins; "auto" takes 2; an explicit "tree"
        without tree_finish is the pure tree, except in a batch, which
        takes the hybrid (the pure tree reads its level count back)."""
        if self.tree_finish is not None:
            return self.tree_finish
        return 2 if self.smvp_mode == "auto" or batch else None

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
        points = self._point_prep(path, point_words)
        sw = words_to_device(scalar_words, self.device)
        return self._msm_set(self._smvp_fn(path), points, sw, chunk_size)

    def _point_prep(self, path: str, point_words: np.ndarray) -> torch.Tensor:
        """Everything that depends on the points alone: the copy, the
        Montgomery table, and the form of it that the path's SMVP reads."""
        table = mont_point_table(words_to_device(point_words, self.device))
        if path in ("tree", "stream"):
            return build_signed_table(table)
        return make_wide_rows(table) if path == "fused" else table

    def _smvp_fn(self, path: str, batch: bool = False):
        if path == "tree":
            return functools.partial(self._smvp_tree, tree_k=self._tree_k(batch))
        return {"stream": self._smvp_stream, "fused": self._smvp_fused,
                "legacy": self._smvp_legacy}[path]

    def _msm_set(self, smvp, points, sw: torch.Tensor, chunk_size: int):
        """Everything that depends on the scalars: plan, SMVP, BPR and the
        Montgomery exit over prepared points and device scalar words."""
        num_windows = num_windows_for(chunk_size)
        digits = decompose_scalars_signed(sw, chunk_size, num_windows)
        plan = build_bucket_plan(digits, chunk_size)
        return mont_mul_const(smvp(points, plan, chunk_size, num_windows), 1)

    def _bpr_order(self, num_windows: int, chunk_size: int) -> torch.Tensor:
        return bpr_order_on(num_windows, chunk_size, self.num_bpr_threads,
                            self.device)

    def _reduce_blocks(self, blocks, layout, chunk_size, num_windows):
        """Block-ordered buckets -> window sums: the permute with the BPR
        walk order composed in, then the gather-free BPR."""
        order = self._bpr_order(num_windows, chunk_size)
        buckets = permute_buckets(blocks, layout, order=order)
        return reduce_buckets_prearranged(
            buckets, num_windows, chunk_size, self.num_bpr_threads
        )

    def _smvp_tree(self, signed_table, plan, chunk_size, num_windows, tree_k):
        kn = plan.sorted_vals.shape[0]
        if tree_k is not None:
            tplan = build_hybrid_plan(
                plan.starts, plan.lens, kn, tree_k, num_windows
            )
            blocks = tree_smvp_hybrid(
                signed_table, plan.sorted_vals, tplan, tree_k
            )
            return self._reduce_blocks(
                blocks, tplan.layout, chunk_size, num_windows
            )
        tplan = build_tree_plan(plan.starts, plan.lens, kn, num_windows)
        # the pure tree's one host readback: the longest bucket picks the
        # level count
        levels = num_levels(int(tplan.max_len))
        final, s_fin = tree_smvp(signed_table, plan.sorted_vals, tplan, levels)
        buckets = permute_tree(
            final,
            real_bucket_view(s_fin, num_windows),
            real_bucket_view(tplan.lens, num_windows),
            order=self._bpr_order(num_windows, chunk_size),
        )
        return reduce_buckets_prearranged(
            buckets, num_windows, chunk_size, self.num_bpr_threads
        )

    def _smvp_stream(self, signed_table, plan, chunk_size, num_windows):
        layout = build_stream_layout(plan.starts, plan.lens, num_windows)
        blocks = accumulate_buckets_streamed(
            signed_table, plan.sorted_vals, layout
        )
        return self._reduce_blocks(blocks, layout, chunk_size, num_windows)

    def _smvp_fused(self, rows, plan, chunk_size, num_windows):
        n = rows.shape[0]
        if windowed_supported(plan.starts.shape[0], num_windows, n):
            buckets = accumulate_buckets_windowed(
                rows, plan.sorted_vals, plan.starts, plan.lens, num_windows
            )
        else:
            buckets = accumulate_buckets_fused(
                pregather_signed(rows, plan.sorted_vals), plan.starts, plan.lens
            )
        order = self._bpr_order(num_windows, chunk_size)
        return reduce_buckets_prearranged(
            buckets[:, order], num_windows, chunk_size, self.num_bpr_threads
        )

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
            order = self._bpr_order(len(windows), chunk_size)
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

    def compute_msm_batch(
        self,
        points: Any,
        scalars_batch: Sequence[Any],
        devices: Sequence[Any] | None = None,
    ) -> list[dict[str, int]]:
        """Batched MSM over a fixed point set: one result per scalar set.

        On the tree and stream paths the points are copied, converted and
        tabled once; each set then costs its scalar copy, plan, SMVP, BPR
        and Montgomery exit, enqueued without the host waiting for the
        device, and every set's window sums come back in one copy before
        the host Horner.  The other paths run compute_msm per set.  devices
        may name the engine's own device; a pool of more than one is not
        ported (ROADMAP item 16)."""
        if devices is not None and len(devices) > 1:
            raise NotImplementedError(
                "set-parallel batches over a device pool are not ported: "
                "ROADMAP item 16"
            )
        if devices and _device_key(devices[0]) != _device_key(self.device):
            raise ValueError(
                f"the engine runs on {self.device}, not on {devices[0]}: "
                "give the device to the constructor"
            )
        point_words = self._prepare_points(points)
        n = point_words.shape[-1]
        chunk_size = self._chunk_for(n)
        path = self._select_smvp(chunk_size, n)
        if path not in ("tree", "stream"):
            return [self.compute_msm(point_words, sc) for sc in scalars_batch]
        sws = [self._prepare_scalars(sc) for sc in scalars_batch]
        for sw in sws:
            self._validate(n, sw)
        shared = self._batch_prep(path, point_words)
        coords = self._batch_sets(shared, sws, chunk_size)
        return self._batch_finish(coords, chunk_size)

    def _batch_prep(self, path: str, point_words: np.ndarray):
        """The batch's shared work: (the path's SMVP, the prepared points)."""
        return self._smvp_fn(path, batch=True), self._point_prep(path, point_words)

    def _batch_sets(self, shared, scalar_words_list, chunk_size: int):
        """Per-set work, enqueued back to back: nothing here makes the host
        wait for the device."""
        smvp, points = shared
        return [
            self._msm_set(smvp, points, words_to_device(sw, self.device),
                          chunk_size)
            for sw in scalar_words_list
        ]

    def _batch_finish(self, coords, chunk_size: int) -> list[dict[str, int]]:
        """One readback of every set's window sums, then the host Horner."""
        if not coords:
            return []
        host = torch.stack(coords).cpu()
        return [self._finalize(c, chunk_size) for c in host]
