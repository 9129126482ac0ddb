"""The cuZK MSM engine: tree (hybrid and pure), stream, fused and legacy
SMVP paths, and batch mode over a fixed point set, for BLS12-377 G1 and
Twisted Edwards BLS12 (the curve's group and field picked once per
engine).

compute_msm(points, scalars) -> {"x": int, "y": int} runs, on one device
(parallel/mesh.py:ShardedMsmEngine runs it over shards of the points):
  0. the copy: wire words to the card as they come (a wire buffer's
     point-major words, a word array's word-major ones), staged through
     pinned memory in chunks whose copies start as each is filled;
  1. point prep: wire words -> in one launch of kernel 1, the form the
     path reads: the signed table (tree, stream, legacy) or the
     Montgomery table (for Edwards with t = x*y; fused: then its wide
     rows);
  2. plan: signed window digits -> stable per-window sort -> bucket
     segments (plain PyTorch);
  3. SMVP, by _select_smvp (the JAX engine's policy on a TPU; with
     autotune on, the default, a tuned window size, path and K for this
     device, curve and n come first: harness/autotune.py):
     - "tree" (n >= 2^18, chunk >= 9): the phantom-extended plan, tree
       levels 1..K (kernel 2), then the packed finish (kernel 3), K =
       tree_finish; with smvp_mode="tree" and no tree_finish, the pure
       tree: every level until each bucket is one node, the level count
       read back once as the longest bucket;
     - "stream" (chunk >= 9 below that): the length-sorted layout, then
       kernel 5 over the signed table and the sorted entry stream;
     - "fused" (where all buckets fill whole 256-lane blocks, e.g. the
       default chunk 4 below 2^16): the sorted rows gathered once, then
       kernel 8 over pieces of at most PIECE of each bucket's contiguous
       rows and kernel 2's full levels folding each bucket's pieces
       (ops/smvp_kernel.py), window by window where a window's buckets
       fill whole blocks, else in one pass of each;
     - "legacy" (otherwise, and PippengerMsmEngine): kernel 6 over every
       bucket in one launch, a thread a bucket, or where buckets run
       longer than PIECE entries on average (chunk 4), over their pieces of
       at most PIECE entries, folded as on the fused path;
  4. BPR (kernel 4): every path gathers its buckets into BPR walk order
     once (tree and stream compose that into their block permute) and
     runs reduce_buckets_prearranged;
  5. Montgomery exit (kernel 1) and one readback of num_windows points;
  6. Horner across windows on the host, with Python integers.
compute_msm_batch(points, [scalars, ...]) runs step 1 once (_batch_prep,
the prepared key) and steps 2-5 per scalar set over it without the host
waiting for the device between sets (tree, stream and fused paths;
_run_sets), then reads every set's window sums back in one copy; with a
pool of devices, set i runs whole on devices[i % D].  ResidentBases keeps
a prepared key across calls (api.multi_scalar_mult_init): each call runs
_run_sets alone.
prewarm(n) builds and loads the kernels and makes one throwaway run of
n's path; debug_check(points, scalars) holds the
point prep, the whole plan and sampled bucket sums of the stream kernel
against host models at the full n.
PyTorch runs eagerly, so the JAX package's plan/main program split, its
size classes and their host readbacks, and its compile caches have no
counterpart here; the pure tree's readback of its level count stays.
Stages run in spans of utils/trace.py (the input checks in msm.prepare,
0 msm.copy, 1 msm.point_prep, 2 msm.plan with the BPR order and the
path's own plan, 3 msm.smvp, 6 msm.horner), once a set in a batch, where
msm.set holds each set's scalar copy and steps 2-5; BPR, the exit and the
readback only enqueue behind the SMVP or wait for the device, so they need
none.  ResidentBases' set-up runs in msm.bases_init, and each set of its
calls counts the key's bytes (msm.key_bytes).
"""

from __future__ import annotations

import functools
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import kernels
from ..ops.bpr import bpr_order_on, reduce_buckets_prearranged
from ..ops.buckets import IDX_MASK, SIGN_BIT, build_bucket_plan, legacy_buckets
from ..ops.convert import WireLayout, ints_to_words, wire_words
from ..ops.decompose import (
    SCALAR_BITS,
    choose_chunk_size,
    decompose_scalars_signed,
    num_windows_for,
)
from ..ops.kernels import (
    PLANE,
    SIGNED,
    mont_mul_const,
    point_prep,
    point_prep_plain,
)
from ..ops.smvp_kernel import (
    PIECE,
    accumulate_buckets_fused,
    accumulate_buckets_windowed,
    fold_pieces,
    fused_supported,
    make_wide_rows,
    piece_plan,
    pregather_signed,
    windowed_supported,
)
from ..ops.smvp_stream import (
    accumulate_buckets_streamed,
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
from ..utils import trace

#: n from which "auto" takes the hybrid tree (the JAX package's static
#: policy, models/cuzk.py:_select_smvp)
TREE_MIN_N = 1 << 18
#: bytes of one wire coordinate
COORD_BYTES = {CurveId.BLS12_377: 48, CurveId.EDWARDS_BLS12: 32}
SMVP_MODES = ("auto", "tree", "stream", "legacy", "fused")
#: bytes of the pinned buffer that one chunk of the staged copy fills:
#: a few MB, so that the first chunk's copy starts early and the host fill
#: and the device copy overlap
STAGE_CHUNK_BYTES = 4 << 20
#: host threads that fill the pinned buffer (numpy's copy of a word array
#: releases the GIL); an array of fewer than this many chunks is staged in
#: one piece on the calling thread, which measured faster at 2^17 (4-13
#: MB) and slower at 2^20 (32-101 MB) on an H100 machine, where one thread
#: filling the chunks was slower than one piece (PERF.md)
STAGE_WORKERS = 4


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


def staging_chunks(rows: int, row_bytes: int) -> list[tuple[int, int]]:
    """The staged copy's chunks: [lo, hi) ranges of whole rows of about
    STAGE_CHUNK_BYTES (at least one row each) that cover [0, rows) in
    order; one chunk for all rows below STAGE_WORKERS chunks' bytes."""
    if rows * row_bytes < STAGE_WORKERS * STAGE_CHUNK_BYTES:
        return [(0, rows)]
    step = max(1, STAGE_CHUNK_BYTES // row_bytes)
    return [(lo, min(rows, lo + step)) for lo in range(0, rows, step)]


def words_to_device(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 host word array -> int32 tensor of the same bits and shape on
    device (an array whose last axis is contiguous: a view of a shard's
    columns, too).  To a CUDA device the words go through a pinned buffer in
    chunks of whole rows of the array's 2-D view (all axes but the last
    merged: the points of point-major words, the word planes of word-major
    ones), filled by STAGE_WORKERS host threads; each chunk's copy is enqueued
    as soon as it is filled (a small array: one fill and one copy), on the
    current stream of `device` (PyTorch's copies enter the destination's
    device), and the host does not wait for the stream.  A tensor (int32
    words staged earlier) is moved to device, and is not copied where it
    lies there."""
    with trace.span("msm.copy"):
        if isinstance(words, torch.Tensor):
            return words.to(device)
        host = words.view(np.int32)
        if device.type != "cuda":
            return torch.from_numpy(host.copy()).to(device)
        rows = host.reshape(int(np.prod(host.shape[:-1])), host.shape[-1])
        staged = torch.empty(rows.shape, dtype=torch.int32, pin_memory=True)
        pinned = staged.numpy()
        chunks = staging_chunks(rows.shape[0], 4 * rows.shape[1])
        if len(chunks) == 1:
            np.copyto(pinned, rows)
            return staged.to(device, non_blocking=True).reshape(host.shape)
        out = torch.empty(rows.shape, dtype=torch.int32, device=device)

        def fill(lo, hi):
            np.copyto(pinned[lo:hi], rows[lo:hi])

        with ThreadPoolExecutor(STAGE_WORKERS) as pool:
            filled = [pool.submit(fill, lo, hi) for lo, hi in chunks]
            for (lo, hi), done in zip(chunks, filled):
                done.result()
                out[lo:hi].copy_(staged[lo:hi], non_blocking=True)
        return out.reshape(host.shape)


def mont_point_table(point_words: torch.Tensor, group=C.G1) -> torch.Tensor:
    """Plain form of the point prep's PLANE output from word-major wire
    words: G1 (2, 12, N) -> (26, N) (x; y); Edwards (2, 8, N) -> (27, N)
    (x; y; t = x*y)."""
    layout = WireLayout.of(point_words, False, group.ctx.nw - 1, 2)
    return point_prep_plain(point_words, layout, group, PLANE)


class Smvp(NamedTuple):
    """A path's SMVP in two steps (CuzkMsmEngine._smvp_fn):
    plan(table, plan, chunk_size, num_windows) -> the path's own plan from
    the bucket plan; buckets(table, plan, own_plan, chunk_size,
    num_windows, order) -> the canonical buckets gathered in order
    (window-major with order None, which the fused path does not take)."""

    plan: Callable
    buckets: Callable


class PreparedKey(NamedTuple):
    """A point set prepared once for any number of scalar sets
    (CuzkMsmEngine._batch_prep): the path's SMVP and the table it reads
    (the signed table, the Montgomery table or the fused path's wide
    rows), on one device."""

    smvp: Smvp
    table: torch.Tensor


class CuzkMsmEngine:
    """End-to-end MSM engine for one curve on one device."""

    def __init__(
        self,
        curve: CurveId = CurveId.BLS12_377,
        *,
        chunk_size: int | None = None,
        num_bpr_threads: int = 512,
        tree_finish: int | None = None,  # K, the hybrid finish level
        smvp_mode: str = "auto",
        force_recompile: bool = False,
        autotune: bool = True,
        device=None,
    ):
        """smvp_mode "auto" follows the JAX engine's policy (_select_smvp)
        and answers at every n; "tree", "stream", "fused" and "legacy"
        force that path at any n and chunk size.  tree_finish is K of the
        hybrid tree; None means 2 under "auto" and the pure tree under an
        explicit "tree".  autotune consults the persisted tuning table
        (harness/autotune.py) for this device, curve and n, as the JAX
        engine does: its window size, its "auto" path and its K; with no
        entry the static policy stands.  force_recompile compiles every
        kernel library again from csrc/ (kernels.rebuild) on a CUDA
        device; an engine on the CPU launches no kernel and compiles
        nothing."""
        if num_bpr_threads < 1 or num_bpr_threads & (num_bpr_threads - 1):
            raise ValueError(
                f"num_bpr_threads must be a power of two, got {num_bpr_threads}"
            )
        if tree_finish is not None and tree_finish < 1:
            raise ValueError(f"tree_finish must be >= 1, got {tree_finish}")
        if smvp_mode not in SMVP_MODES:
            raise ValueError(f"unknown smvp_mode {smvp_mode!r}")
        self.curve = curve
        self.group = C.group_ops(curve)
        self.coord_bytes = COORD_BYTES[curve]
        self.chunk_size_override = chunk_size
        self.num_bpr_threads = num_bpr_threads
        self.tree_finish = tree_finish
        self.smvp_mode = smvp_mode
        self.autotune = autotune
        self.device = resolve_device(device)
        if force_recompile and self.device.type == "cuda":
            kernels.rebuild()

    def _tuned(self, n: int) -> dict:
        """The tuning table's entry for this device, curve and n ({} with
        autotune off or none tuned)."""
        if not self.autotune:
            return {}
        from ..harness.autotune import lookup_entry

        return lookup_entry(self.curve, n, device=self.device)

    def _select_smvp(self, chunk_size: int, n: int) -> str:
        """Resolve smvp_mode to the path for this size.  "auto" is the JAX
        engine's policy on a TPU: a tuned "tree" or "stream" for this n
        where stream_supported(chunk_size) (a stale entry cannot pick a
        path for other window shapes); else, where a window's buckets fill
        whole 256-lane slabs (stream_supported: chunk_size >= 9), the
        hybrid tree from n = 2^18 and the stream path below; else the
        fused path where _fused_ok; else legacy.  An explicit mode runs at
        any n and chunk size: no kernel here has a lane constraint."""
        if self.smvp_mode != "auto":
            return self.smvp_mode
        tuned = self._tuned(n).get("smvp")
        if tuned in ("tree", "stream") and stream_supported(chunk_size):
            return tuned
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

    def _tree_k(self, n: int | None = None, batch: bool = False) -> int | None:
        """The hybrid finish level K, or None for the pure tree: an
        explicit tree_finish wins; "auto" takes the tuned K for n, else 2;
        an explicit "tree" without tree_finish is the pure tree, except in
        a batch, which takes the hybrid's 2 (the pure tree reads its level
        count back)."""
        if self.tree_finish is not None:
            return self.tree_finish
        if self.smvp_mode != "auto":
            return 2 if batch else None
        tuned = self._tuned(n).get("tree_finish") if n is not None else None
        return int(tuned) if tuned else 2

    def _chunk_for(self, n: int) -> int:
        """The window size: an explicit chunk_size, then the tuned one for
        n, then the static policy (choose_chunk_size)."""
        return (self.chunk_size_override or self._tuned(n).get("chunk")
                or choose_chunk_size(n))

    # -- input normalization (reference wire formats) -----------------------
    # Prepared inputs are (host uint32 words, their WireLayout): a wire
    # buffer's words in the order it holds them (point-major, a view, no
    # copy), a uint32 array as given (word-major: points (2, k, N),
    # scalars (8, N)), Python ints through their wire bytes.

    def _prepare_points(self, points: Any) -> tuple[np.ndarray, WireLayout]:
        if isinstance(points, np.ndarray) and points.dtype == np.uint32:
            return points, WireLayout.of(points, False, self.coord_bytes // 4,
                                         2)
        if not isinstance(points, (bytes, bytearray, memoryview)):
            cb = self.coord_bytes
            points = b"".join(int(p[0]).to_bytes(cb, "little")
                              + int(p[1]).to_bytes(cb, "little")
                              for p in points)
        return wire_words(points, self.coord_bytes, 2)

    @staticmethod
    def _prepare_scalars(scalars: Any) -> tuple[np.ndarray, WireLayout]:
        if isinstance(scalars, np.ndarray) and scalars.dtype == np.uint32:
            return scalars, WireLayout.of(scalars, False, SCALAR_BITS // 32)
        if not isinstance(scalars, (bytes, bytearray, memoryview)):
            scalars = b"".join(int(s).to_bytes(SCALAR_BITS // 8, "little")
                               for s in scalars)
        return wire_words(scalars, SCALAR_BITS // 8)

    @staticmethod
    def _validate(n: int, scalars: tuple[np.ndarray, WireLayout]) -> None:
        words, layout = scalars
        if layout.n != n:
            raise ValueError(f"point/scalar count mismatch: {n} vs {layout.n}")
        if n == 0:
            raise ValueError("empty MSM")
        # the signed decomposition's final carry is zero only below 2^253
        if bool((layout.word(words, 0, 7) >> 29).any()):
            raise ValueError("scalars must be < 2^253")

    # -- device pipeline ------------------------------------------------------

    def msm_device(self, points, scalars, chunk_size: int) -> torch.Tensor:
        """The device pipeline over prepared points and scalars (host words
        and their layouts): returns the (39|36, num_windows) canonical
        window sums in plain (non-Montgomery) form, on the device."""
        n = points[1].n
        path = self._select_smvp(chunk_size, n)
        prepared = self._point_prep(path, points)
        return self._msm_set(self._smvp_fn(path, n), prepared,
                             self._scalars_to_device(scalars), chunk_size)

    def _point_prep(self, path: str, points, device=None) -> torch.Tensor:
        """Everything that depends on the points alone: the copy to device
        (default the engine's), then the point prep's one launch into the
        form the path's SMVP reads (the fused path's wide rows from the
        Montgomery table)."""
        words, layout = points
        dev_words = words_to_device(words, device or self.device)
        with trace.span("msm.point_prep"):
            if path in ("tree", "stream", "legacy"):
                return point_prep(dev_words, layout, self.group, SIGNED)
            table = point_prep(dev_words, layout, self.group, PLANE)
            return (make_wide_rows(table, self.group) if path == "fused"
                    else table)

    def _scalars_to_device(self, scalars, device=None) -> torch.Tensor:
        """Prepared scalars -> their (8, N) words on device (default the
        engine's; point-major wire words transposed there, after the
        copy)."""
        words, layout = scalars
        sw = words_to_device(words, device or self.device)
        return sw.T.contiguous() if layout.point_major else sw

    def _smvp_fn(self, path: str, n: int, batch: bool = False) -> Smvp:
        if path == "tree":
            k = self._tree_k(n, batch)
            return Smvp(functools.partial(self._plan_tree, tree_k=k),
                        functools.partial(self._buckets_tree, tree_k=k))
        return {"stream": Smvp(self._plan_stream, self._buckets_stream),
                "fused": Smvp(self._plan_fused, self._buckets_fused),
                "legacy": Smvp(self._plan_legacy, self._buckets_legacy)}[path]

    def _msm_set(self, smvp: Smvp, points, sw: torch.Tensor, chunk_size: int):
        """Everything that depends on the scalars, over prepared points and
        device scalar words: the plan (signed digits, the bucket plan, the
        BPR walk order and the path's own plan), the path's SMVP into that
        order, BPR and the Montgomery exit."""
        num_windows = num_windows_for(chunk_size)
        with trace.span("msm.plan"):
            digits = decompose_scalars_signed(sw, chunk_size, num_windows)
            plan = build_bucket_plan(digits, chunk_size)
            order = self._bpr_order(num_windows, chunk_size, points.device)
            own = smvp.plan(points, plan, chunk_size, num_windows)
        with trace.span("msm.smvp"):
            buckets = smvp.buckets(points, plan, own, chunk_size, num_windows,
                                   order)
        sums = self._bpr(buckets, chunk_size, num_windows)
        return mont_mul_const(sums, 1, self.group.ctx)

    def _bpr_order(self, num_windows: int, chunk_size: int,
                   device=None) -> torch.Tensor:
        return bpr_order_on(num_windows, chunk_size, self.num_bpr_threads,
                            device or self.device)

    def _bpr(self, buckets, chunk_size, num_windows):
        """BPR over buckets gathered in bpr_order: the window sums."""
        return reduce_buckets_prearranged(
            buckets, num_windows, chunk_size, self.num_bpr_threads, self.group
        )

    def _plan_tree(self, signed_table, plan, chunk_size, num_windows, tree_k):
        """The hybrid plan (K = tree_k), or for the pure tree (None) its
        plan and level count."""
        kn = plan.sorted_vals.shape[0]
        if tree_k is not None:
            return build_hybrid_plan(plan.starts, plan.lens, kn, tree_k,
                                     num_windows)
        tplan = build_tree_plan(plan.starts, plan.lens, kn, num_windows)
        # the pure tree's one host readback: the longest bucket picks the
        # level count
        return tplan, num_levels(int(tplan.max_len))

    def _buckets_tree(self, signed_table, plan, tplan, chunk_size,
                      num_windows, order, tree_k):
        """The hybrid tree or the pure tree, its buckets permuted into
        order (the BPR walk composed in)."""
        if tree_k is not None:
            blocks = tree_smvp_hybrid(
                signed_table, plan.sorted_vals, tplan, tree_k, self.group
            )
            return permute_buckets(blocks, tplan.layout, order=order,
                                   group=self.group)
        tplan, levels = tplan
        final, s_fin = tree_smvp(signed_table, plan.sorted_vals, tplan, levels,
                                 self.group)
        return permute_tree(
            final,
            real_bucket_view(s_fin, num_windows),
            real_bucket_view(tplan.lens, num_windows),
            order=order,
            group=self.group,
        )

    def _plan_stream(self, signed_table, plan, chunk_size, num_windows):
        return build_stream_layout(plan.starts, plan.lens, num_windows)

    def _buckets_stream(self, signed_table, plan, layout, chunk_size,
                        num_windows, order):
        blocks = accumulate_buckets_streamed(
            signed_table, plan.sorted_vals, layout, self.group
        )
        return permute_buckets(blocks, layout, order=order, group=self.group)

    def _plan_fused(self, rows, plan, chunk_size, num_windows):
        """None: the fused path sums straight off the bucket plan."""
        return None

    def _buckets_fused(self, rows, plan, own, chunk_size, num_windows, order):
        if windowed_supported(plan.starts.shape[0], num_windows, rows.shape[0]):
            return accumulate_buckets_windowed(
                rows, plan.sorted_vals, plan.starts, plan.lens, num_windows,
                self.group, order=order
            )
        return accumulate_buckets_fused(
            pregather_signed(rows, plan.sorted_vals, self.group), plan.starts,
            plan.lens, self.group, max_len=rows.shape[0], order=order
        )

    def _plan_legacy(self, signed_table, plan, chunk_size, num_windows):
        """Where a window's mean bucket (n / h entries) is longer than
        PIECE, as at chunk 4, the piece plan (pieces of at most PIECE
        entries), else None."""
        n = signed_table.shape[0] // 2
        if n >> (chunk_size - 1) > PIECE:
            return piece_plan(plan.starts, plan.lens,
                              plan.sorted_vals.shape[0], n, PIECE)
        return None

    def _buckets_legacy(self, signed_table, plan, pp, chunk_size,
                        num_windows, order):
        """Kernel 6 in one launch, its buckets gathered into order.  Over
        the piece plan pp, one thread sums a piece and a second launch
        folds each bucket's pieces (tree.cu's fold, as on the fused path):
        one thread a bucket would walk a chain of thousands of adds on a
        few SMs.  Else one thread sums a whole bucket, word for word the
        JAX package's legacy sum; a bucket summed in pieces is the same
        point."""
        group = self.group
        if pp is not None:
            sums = legacy_buckets(signed_table, plan.sorted_vals, pp.starts,
                                  pp.lens, group)
            buckets, _ = fold_pieces(sums, pp.counts, pp.offsets, pp.caps,
                                     group)
        else:
            buckets = legacy_buckets(signed_table, plan.sorted_vals,
                                     plan.starts, plan.lens, group)
        return buckets if order is None else buckets[:, order]

    def _finalize(self, coords: torch.Tensor, chunk_size: int) -> dict[str, int]:
        """The window sums read back (where the host waits for the device),
        then the host Horner."""
        return self._horner(coords.cpu(), chunk_size)

    def _horner(self, coords: torch.Tensor, chunk_size: int) -> dict[str, int]:
        """Host window sums -> the affine result: Horner across windows
        with Python integers."""
        with trace.span("msm.horner"):
            nw = self.group.ctx.nw
            cols = [F.plane_to_ints(coords[c * nw : (c + 1) * nw])
                    for c in range(coords.shape[0] // nw)]
            if self.curve == CurveId.BLS12_377:
                point, ogroup, to_affine = (ocurve.ProjectivePoint, omsm.G1,
                                            ocurve.g1_to_affine)
            else:
                point, ogroup, to_affine = (ocurve.ExtendedPoint, omsm.EDWARDS,
                                            ocurve.ed_to_affine)
            window_pts = [point(*v) for v in zip(*cols)]
            x, y = to_affine(omsm.horner(window_pts, chunk_size, ogroup))
            return {"x": x, "y": y}

    def compute_msm(self, points: Any, scalars: Any) -> dict[str, int]:
        with trace.span("msm.prepare"):
            points = self._prepare_points(points)
            scalars = self._prepare_scalars(scalars)
            self._validate(points[1].n, scalars)
        return self._compute(points, scalars)

    def _compute(self, points, scalars) -> dict[str, int]:
        """compute_msm over prepared and checked points and scalars."""
        n = points[1].n
        chunk_size = self._chunk_for(n)
        coords = self.msm_device(points, scalars, chunk_size)
        return self._finalize(coords, chunk_size)

    def compute_msm_batch(
        self,
        points: Any,
        scalars_batch: Sequence[Any],
        devices: Sequence[Any] | None = None,
    ) -> list[dict[str, int]]:
        """Batched MSM over a fixed point set: one result per scalar set.

        On the tree, stream and fused paths the points are copied,
        converted and tabled once; each set then costs its scalar copy,
        plan, SMVP, BPR and Montgomery exit, enqueued without the host
        waiting for the device, and every set's window sums come back in
        one copy before the host Horner: the prepared key (_batch_prep),
        then the sets over it (_run_sets), as ResidentBases runs them.
        The legacy path (a baseline) runs compute_msm per set.

        devices: a device pool for set-parallel execution (the JAX
        package's _msm_batch_stream_pool): with more than one member, and
        where the path is tree or stream, set i runs whole on
        devices[i % D] on the stream path, the point prep once per
        distinct device of the pool and one readback per member; members
        may repeat a device.  One member must be the engine's own
        device."""
        if devices and len(devices) == 1 and _device_key(
                devices[0]) != _device_key(self.device):
            raise ValueError(
                f"the engine runs on {self.device}, not on {devices[0]}: "
                "give the device to the constructor"
            )
        pool = [resolve_device(d) for d in devices or ()]
        with trace.span("msm.prepare"):
            points = self._prepare_points(points)
            n = points[1].n
            sws = self._check_sets(n, scalars_batch)
        chunk_size = self._chunk_for(n)
        path = self._select_smvp(chunk_size, n)
        if path not in ("tree", "stream", "fused"):
            out = []
            for sw in sws:
                with trace.span("msm.set"):
                    out.append(self._compute(points, sw))
            return out
        if len(pool) > 1 and path in ("tree", "stream"):
            return self._batch_pool(points, sws, chunk_size, pool)
        return self._run_sets(self._batch_prep(path, points), sws, chunk_size)

    def _check_sets(self, n: int, scalars_batch: Sequence[Any]) -> list:
        """The prepared scalar sets of a batch, every one checked against n
        before any is enqueued.  A check reads the top word of every
        scalar, so the whole set, while the device waits: the sets are
        checked side by side (numpy releases the GIL)."""
        sws = [self._prepare_scalars(sc) for sc in scalars_batch]
        if sws:
            with ThreadPoolExecutor(min(len(sws), STAGE_WORKERS)) as pool:
                list(pool.map(functools.partial(self._validate, n), sws))
        return sws

    def _batch_pool(self, points, sws, chunk_size: int, pool: list):
        """Set-parallel batch over a device pool: the point prep once a
        distinct device of the pool (its signed table; members that repeat
        a device share it), then each set's scalar copy, plan, stream SMVP,
        BPR and exit on member i % D, all enqueued before any wait; one
        readback per member of its sets' window sums, then the host
        Horner."""
        keys = {}
        for dev in pool:
            if _device_key(dev) not in keys:
                keys[_device_key(dev)] = self._batch_prep("stream", points, dev)
        coords = []
        for i, sc in enumerate(sws):
            dev = pool[i % len(pool)]
            smvp, table = keys[_device_key(dev)]
            with trace.span("msm.set"):
                coords.append(self._msm_set(
                    smvp, table, self._scalars_to_device(sc, dev), chunk_size))
        host = {}
        for k in range(min(len(pool), len(coords))):
            mine = range(k, len(coords), len(pool))
            host.update(zip(mine, torch.stack([coords[i] for i in mine])
                            .cpu()))
        return [self._horner(host[i], chunk_size)
                for i in range(len(coords))]

    def _batch_prep(self, path: str, points, device=None) -> PreparedKey:
        """The batch's shared work, the prepared key: the path's SMVP (the
        hybrid tree's K for a batch) and the point prep on device (default
        the engine's)."""
        return PreparedKey(self._smvp_fn(path, points[1].n, batch=True),
                           self._point_prep(path, points, device))

    def _run_sets(self, key: PreparedKey, scalars_list,
                  chunk_size: int) -> list[dict[str, int]]:
        """Checked scalar sets over a prepared key: each set enqueued back
        to back, then one readback and the host Horner."""
        return self._batch_finish(self._batch_sets(key, scalars_list,
                                                   chunk_size), chunk_size)

    def _batch_sets(self, key: PreparedKey, scalars_list, chunk_size: int):
        """Per-set work, enqueued back to back, a set in one msm.set span:
        nothing here makes the host wait for the device."""
        out = []
        for sc in scalars_list:
            with trace.span("msm.set"):
                out.append(self._msm_set(key.smvp, key.table,
                                         self._scalars_to_device(sc),
                                         chunk_size))
        return out

    def _batch_finish(self, coords, chunk_size: int) -> list[dict[str, int]]:
        """One readback of every set's window sums, then the host Horner."""
        if not coords:
            return []
        host = torch.stack(coords).cpu()
        return [self._horner(c, chunk_size) for c in host]

    # -- warm-up and stage checks -------------------------------------------

    def prewarm(self, n: int, chunk_size: int | None = None,
                background: bool = False):
        """Make the first call of size n cheap: one throwaway msm_device
        run of the path _select_smvp picks for n, whose first launch on a
        CUDA device builds (where not built yet) and loads every kernel
        library; it also makes the CUDA context and the allocator's blocks.
        Its inputs are valid: the generator in every lane, scalars from
        np.random.RandomState(7) below 2^253.  On the CPU nothing is built
        and the run takes the plain forms.  background=True runs this in a
        daemon thread and returns the Thread; a call made meanwhile waits
        for the libraries' lock and is correct either way."""
        if background:
            t = threading.Thread(target=self.prewarm, args=(n, chunk_size),
                                 daemon=True)
            t.start()
            return t
        chunk = chunk_size or self._chunk_for(n)
        g = (ocurve.G1_GENERATOR if self.curve == CurveId.BLS12_377
             else ocurve.ED_GENERATOR)
        k = self.coord_bytes // 4
        pw = np.ascontiguousarray(np.broadcast_to(
            np.stack([ints_to_words([g.x], k), ints_to_words([g.y], k)]),
            (2, k, n)))
        sw = np.random.RandomState(7).randint(
            0, 1 << 32, size=(8, n), dtype=np.uint64).astype(np.uint32)
        sw[7] &= 0x1FFFFFFF
        out = self.msm_device(self._prepare_points(pw),
                              self._prepare_scalars(sw), chunk)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return None

    def debug_check(self, point_words, scalar_words,
                    chunk_size: int | None = None, sample: int = 64,
                    rng_seed: int = 1234) -> dict[str, bool]:
        """Stage-by-stage check of one MSM's inputs at their full size,
        each stage against an independent model on the host (the
        reference's debug readbacks, submission.ts:464-798):

        - stage1_mont_convert: `sample` points of kernel 1's Montgomery
          table (point_prep, PLANE) against x R, y R (Edwards also x y R)
          mod p, R = 2^(32 nw), with Python integers;
        - stage2_transpose: the whole plan, exactly: the signed digits
          against a numpy model that reads each window's bits from the
          scalars' bytes and carries by hand, each bucket's start and
          length against the model's counts, and every entry of the sorted
          stream (point index | positive sign << SIGN_BIT) against the
          bucket its position lies in: each point once a window, in the
          bucket and with the sign of its digit;
        - stage3_buckets: the stream kernel (accumulate_buckets_streamed,
          kernel 5) over the whole plan; `sample` nonempty buckets, the
          longest among them, against their sums with Python integers,
          compared as group elements.

        Raises AssertionError at the first mismatch; returns each stage's
        name -> True.  point_words and scalar_words take compute_msm's
        forms."""
        points = self._prepare_points(point_words)
        scalars = self._prepare_scalars(scalar_words)
        n = points[1].n
        self._validate(n, scalars)
        chunk = chunk_size or self._chunk_for(n)
        num_windows = num_windows_for(chunk)
        h = 1 << (chunk - 1)
        group, ctx = self.group, self.group.ctx
        p, nw = ctx.p, ctx.nw
        rng = random.Random(rng_seed)
        # word-major host words: (2, k, n) and (8, n)
        host_pw, host_sw = points[0], scalars[0]
        if points[1].point_major:
            host_pw = host_pw.reshape(n, 2, -1).transpose(1, 2, 0)
        if scalars[1].point_major:
            host_sw = host_sw.T

        def coord(c: int, j: int) -> int:
            return sum(int(w) << (32 * i) for i, w in enumerate(host_pw[c, :, j]))

        results: dict[str, bool] = {}
        dev_words = words_to_device(points[0], self.device)
        table = point_prep(dev_words, points[1], group, PLANE)
        idxs = [rng.randrange(n) for _ in range(min(sample, n))]
        cols = table[:, idxs].cpu()
        for i, j in enumerate(idxs):
            x, y = coord(0, j), coord(1, j)
            want = [x, y] if group is C.G1 else [x, y, x * y]
            got = [F.plane_to_ints(cols[c * nw:(c + 1) * nw, i:i + 1])[0]
                   for c in range(len(want))]
            assert got == [v * ctx.params.r % p for v in want], (
                f"stage1 mismatch at point {j}")
        results["stage1_mont_convert"] = True

        digits = decompose_scalars_signed(self._scalars_to_device(scalars),
                                          chunk, num_windows)
        plan = build_bucket_plan(digits, chunk)
        sbytes = np.zeros((n, 36), dtype=np.int64)
        sbytes[:, :32] = np.ascontiguousarray(
            host_sw.T.astype("<u4")).view(np.uint8)
        want = np.empty((num_windows, n), dtype=np.int64)
        carry = np.zeros(n, dtype=np.int64)
        for w in range(num_windows):
            bit = w * chunk
            b = bit // 8
            v = (sbytes[:, b] | sbytes[:, b + 1] << 8 | sbytes[:, b + 2] << 16
                 | sbytes[:, b + 3] << 24) >> (bit % 8)
            v = (v & ((1 << chunk) - 1)) + carry
            carry = (v >= h).astype(np.int64)
            want[w] = v - (carry << chunk) + h
        assert not carry.any(), "stage2: the top window's carry escaped"
        assert np.array_equal(digits.cpu().numpy(), want), (
            "stage2 digits mismatch")
        signed = want - h
        keys = np.where(signed == 0, h, np.abs(signed) % h)
        rows = np.arange(num_windows)[:, None]
        counts = np.bincount((keys + (h + 1) * rows).ravel(),
                             minlength=num_windows * (h + 1)).reshape(
                                 num_windows, h + 1)
        lens = counts[:, :h].ravel()
        starts = ((np.cumsum(counts, axis=1) - counts)[:, :h]
                  + n * rows).ravel()
        assert np.array_equal(plan.starts.cpu().numpy(), starts), (
            "stage2 starts mismatch")
        assert np.array_equal(plan.lens.cpu().numpy(), lens), (
            "stage2 lens mismatch")
        sv = plan.sorted_vals.cpu().numpy().astype(np.int64)
        idx = (sv & IDX_MASK).reshape(num_windows, n)
        sign = (sv >> SIGN_BIT).reshape(num_windows, n)
        assert idx.max() < n and not (sign >> 1).any(), (
            "stage2 entries out of range")
        assert (np.bincount((idx + n * rows).ravel(),
                            minlength=num_windows * n) == 1).all(), (
            "stage2: a point is not once in every window")
        bucket_at = np.repeat(np.tile(np.arange(h + 1), num_windows),
                              counts.ravel()).reshape(num_windows, n)
        assert (keys[rows, idx] == bucket_at).all(), (
            "stage2 membership mismatch")
        assert (sign == (signed[rows, idx] > 0)).all(), "stage2 sign mismatch"
        results["stage2_transpose"] = True

        layout = build_stream_layout(plan.starts, plan.lens, num_windows)
        blocks = accumulate_buckets_streamed(
            point_prep(dev_words, points[1], group, SIGNED), plan.sorted_vals,
            layout, group)
        buckets = permute_buckets(blocks, layout, group=group)
        nonempty = np.flatnonzero(lens)
        picks = {int(nonempty[np.argmax(lens[nonempty])])}
        while len(picks) < min(sample, nonempty.size):
            picks.add(int(nonempty[rng.randrange(nonempty.size)]))
        picks = sorted(picks)
        cols = buckets[:, picks].cpu()
        if group is C.G1:
            ogroup, from_affine, point = (omsm.G1, ocurve.g1_from_affine,
                                          ocurve.ProjectivePoint)
        else:
            ogroup, from_affine, point = (omsm.EDWARDS, ocurve.ed_from_affine,
                                          ocurve.ExtendedPoint)
        rinv = ctx.params.rinv
        for i, b in enumerate(picks):
            acc = ogroup.zero
            for e in sv[starts[b]:starts[b] + lens[b]].tolist():
                pt = from_affine(coord(0, e & IDX_MASK), coord(1, e & IDX_MASK))
                acc = ogroup.add(acc, pt if e >> SIGN_BIT else ogroup.neg(pt))
            got = point(*(v * rinv % p for v in (
                F.plane_to_ints(cols[c * nw:(c + 1) * nw, i:i + 1])[0]
                for c in range(group.rows // nw))))
            assert ogroup.eq(acc, got), f"stage3 bucket {b} mismatch"
        results["stage3_buckets"] = True
        return results


class ResidentBases:
    """A fixed point set kept on its engine's device for any number of
    batches of scalar sets (api.multi_scalar_mult_init and
    multi_scalar_mult): a prover's commitment key, loaded once.

    Construction checks the points once (compute_msm's forms), copies them
    to the device once and runs the point prep once, into the table the
    path for their n reads (the prepared key); the window, the path and
    the hybrid's K are fixed then, for that n, as compute_msm_batch fixes
    them.  The table is the handle's own: what the caller does to its
    buffer afterwards changes no result.  run(scalars_batch) checks every
    set before it enqueues any, then runs each set's scalar copy, plan,
    SMVP, BPR and exit back to back over the key (the legacy path too),
    one readback and the host Horner: no point moves and no prep runs.
    close(), leaving a with block, or dropping the last reference frees
    the table.  A device pool or the sharded engine over a resident key
    is not offered."""

    def __init__(self, engine: CuzkMsmEngine, points: Any):
        with trace.span("msm.bases_init"):
            prepared = engine._prepare_points(points)
            n = prepared[1].n
            if n == 0:
                raise ValueError("empty MSM: no points")
            self.engine, self.n = engine, n
            self.chunk_size = engine._chunk_for(n)
            self.path = engine._select_smvp(self.chunk_size, n)
            self._key: PreparedKey | None = engine._batch_prep(self.path,
                                                               prepared)
            table = self._key.table
            self.key_bytes = table.numel() * table.element_size()
            if table.is_cuda:
                torch.cuda.synchronize(table.device)

    def run(self, scalars_batch: Sequence[Any]) -> list[dict[str, int]]:
        """One exact affine result per scalar set, in order."""
        if self._key is None:
            raise ValueError("the resident bases are closed")
        eng = self.engine
        with trace.span("msm.prepare"):
            sws = eng._check_sets(self.n, scalars_batch)
        if not sws:
            raise ValueError("empty batch: give at least one scalar set")
        for _ in sws:
            trace.count("msm.key_bytes", self.key_bytes)
        return eng._run_sets(self._key, sws, self.chunk_size)

    def close(self) -> None:
        """Free the table; a closed handle refuses further calls."""
        self._key = None

    def __enter__(self) -> "ResidentBases":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
