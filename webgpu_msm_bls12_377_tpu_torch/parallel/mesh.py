"""Multi-device MSM: the points sharded over a mesh of devices, each shard
running the engine's pipeline up to its partial buckets, the shards joined
in one tail: the JAX package's parallel/mesh.py on torch.distributed.

make_mesh(devices=None, group=None) -> Mesh: this process's shard devices
(None: every local CUDA device; a device may repeat, so that one card or
the CPU holds D shards), the torch.distributed group that spans the
processes (None: one process), its rank and its world size.  D = local
shards x world size, and local shard i is global shard rank x local + i.

ShardedMsmEngine.msm_device(points, scalars, chunk):
  1. the inputs padded with zero scalars to a multiple of D (a zero digit
     skips its bucket, so a pad lane adds nothing), shard g taking columns
     [g m, (g + 1) m), m = n / D: point-major wire words a view of their
     rows, word-major arrays a view of their columns, staged tensors a
     copy of them on their device;
  2. on each local shard's device, one shard after another and before
     anything waits: the copy and point prep, the plan, and the SMVP of
     the path _select_smvp gives for the shard size m (the chunk is taken
     from the whole n), up to the shard's partial buckets: the hybrid or
     pure tree, the stream path, else the legacy bucket sum (the JAX
     sharded engine never runs the fused path);
  3. the tail (mesh.py:_make_sharded_tail): where D > 1 is a power of two
     that divides num_windows (window_sharded), log2(D) rounds of
     recursive halving on the window-major partial buckets: shard g sends
     the half of its window range it does not keep to shard g ^ bit and
     adds what it receives to what it keeps, lane-wise in the lazy domain
     (ops/kernels.py:bpr_add, one launch a shard and round; every operand
     and result stays below 4p, csrc/bpr.cu, so the joined buckets feed
     BPR without a canon); then BPR on its kw = num_windows / D windows
     gathered into bpr_order(kw), the Montgomery exit, and an all-gather
     of the window blocks in shard order.  Otherwise BPR on all windows on
     every shard, the window sums gathered onto the first shard's device
     and added up a tree there (bpr_add, one launch a level), one canon
     and the exit.  Shards in one process exchange by .to(device), which
     copies nothing where they share a device; shards in other processes
     through torch.distributed point-to-point (batch_isend_irecv) and
     all_gather.  The result, the (39|36, num_windows) plain window sums,
     is replicated in every process, on its first shard's device.
compute_msm (the base engine's) runs msm_device and the host Horner.
compute_msm_batch(points, sets): the point prep once a shard, each set's
plans and SMVPs enqueued shard after shard, the tail a set, one readback
of every set's window sums, then the host Horner.  The JAX package raises
SlabOverflowError on a duplicate-heavy set; the port has no slabs, and
runs such a set exactly.
"""

from __future__ import annotations

import contextlib
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.cuzk import CuzkMsmEngine, resolve_device
from ..ops import curve as C
from ..ops import kernels as K
from ..ops.buckets import build_bucket_plan
from ..ops.convert import WireLayout
from ..ops.decompose import decompose_scalars_signed, num_windows_for
from ..ops.kernels import mont_mul_const
from ..params import CurveId


class Mesh:
    """A 1-D mesh of shards: this process's shard devices and the process
    group that joins it to the others."""

    def __init__(self, devices: list[torch.device], group=None):
        self.devices = devices
        self.group = group
        if group is None:
            self.rank, self.world_size = 0, 1
        else:
            self.rank = dist.get_rank(group)
            self.world_size = dist.get_world_size(group)

    @property
    def local(self) -> int:
        """Shards in this process."""
        return len(self.devices)

    @property
    def size(self) -> int:
        """D, the shards of every process."""
        return self.local * self.world_size

    def index(self, i: int) -> int:
        """The global index of local shard i."""
        return self.rank * self.local + i


def make_mesh(devices=None, group=None) -> Mesh:
    """A mesh over this process's devices (None: every local CUDA device;
    there is no CPU fallback) and the process group `group` (None: one
    process).  Devices may repeat: ["cpu"] * 4 makes four CPU shards,
    ["cuda:0"] * 2 two shards on one card.  Every process of a group must
    hold as many shards."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a mesh takes every local CUDA device unless "
                "it is given its devices (['cpu'] * D for the plain forms)"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh's devices are all CUDA or all CPU, got "
                         f"{[str(d) for d in devs]}")
    mesh = Mesh(devs, group)
    if group is not None:
        counts = [None] * mesh.world_size
        dist.all_gather_object(counts, mesh.local, group=group)
        if len(set(counts)) > 1:
            raise ValueError(f"every process must hold as many shards, got "
                             f"{counts}")
    return mesh


def window_sharded(d: int, num_windows: int) -> bool:
    """The tail's branch (mesh.py:271): the windows are sharded where D > 1
    is a power of two that divides num_windows; else every shard reduces
    every window and the window sums are added up a tree."""
    return d > 1 and d & (d - 1) == 0 and num_windows % d == 0


def _on(dev: torch.device):
    """The device entered for a shard's work (nothing on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else (
        contextlib.nullcontext())


def shard_words(words, layout: WireLayout, lo: int, hi: int):
    """Columns [lo, hi) of prepared words (a host array or a tensor, in
    `layout`), zeros past the layout's n: (words, WireLayout of hi - lo).
    Host words stay a view where no pad is needed; a tensor's shard is a
    contiguous copy on its device."""
    n, m = layout.n, hi - lo
    real = max(0, min(hi, n) - lo)
    shape = ((m, layout.coords * layout.k) if layout.point_major
             else (*layout.shape[:-1], m))
    is_tensor = isinstance(words, torch.Tensor)
    if real == m:
        out = words[lo:hi] if layout.point_major else words[..., lo:hi]
        out = out.contiguous() if is_tensor else out
    else:
        if is_tensor:
            out = torch.zeros(shape, dtype=words.dtype, device=words.device)
        else:
            out = np.zeros(shape, dtype=words.dtype)
        if layout.point_major:
            out[:real] = words[lo:lo + real]
        else:
            out[..., :real] = words[..., lo:lo + real]
    return out, WireLayout(layout.point_major, m, layout.k, layout.coords)


class ShardedMsmEngine(CuzkMsmEngine):
    """CuzkMsmEngine that shards the point and scalar axis over a mesh.

    compute_msm keeps the single-call API; the engine's device is the
    mesh's first local shard device, where the result lies.  prewarm is
    the base engine's: its throwaway run goes through this msm_device."""

    def __init__(self, curve: CurveId = CurveId.BLS12_377,
                 mesh: Mesh | None = None, **kw):
        mesh = mesh if mesh is not None else make_mesh()
        super().__init__(curve, device=mesh.devices[0], **kw)
        self.mesh = mesh

    def _shard_path(self, chunk_size: int, m: int) -> str:
        """A shard's SMVP path, resolved at the shard size m: tree, stream,
        or legacy where the single-device engine would take the fused
        path."""
        path = self._select_smvp(chunk_size, m)
        return "legacy" if path == "fused" else path

    def _padded(self, n: int) -> tuple[int, int]:
        """(n padded to a multiple of D, the shard size m)."""
        d = self.mesh.size
        m = -(-n // d)
        return m * d, m

    def _shard_prep(self, path: str, points, m: int) -> list[torch.Tensor]:
        """Each local shard's copy and point prep (the signed table) on its
        device."""
        words, layout = points
        tables = []
        for i, dev in enumerate(self.mesh.devices):
            lo = self.mesh.index(i) * m
            with _on(dev):
                tables.append(self._point_prep(
                    path, shard_words(words, layout, lo, lo + m), dev))
        return tables

    def _shard_buckets(self, smvp, tables, scalars, m: int,
                       chunk_size: int, order_windows: int | None):
        """Each local shard's scalar copy, plan and SMVP up to its buckets:
        window-major partials (order_windows None), or gathered into
        bpr_order(order_windows) for BPR."""
        words, layout = scalars
        num_windows = num_windows_for(chunk_size)
        out = []
        for i, (dev, table) in enumerate(zip(self.mesh.devices, tables)):
            lo = self.mesh.index(i) * m
            with _on(dev):
                sw = self._scalars_to_device(
                    shard_words(words, layout, lo, lo + m), dev)
                digits = decompose_scalars_signed(sw, chunk_size, num_windows)
                plan = build_bucket_plan(digits, chunk_size)
                order = None if order_windows is None else self._bpr_order(
                    order_windows, chunk_size, dev)
                own = smvp.plan(table, plan, chunk_size, num_windows)
                out.append(smvp.buckets(table, plan, own, chunk_size,
                                        num_windows, order))
        return out

    def _set(self, smvp, tables, scalars, m: int, chunk_size: int):
        """One scalar set over the shards' tables: the shards' buckets, then
        the tail; the (rows, num_windows) plain window sums on the first
        local shard's device."""
        num_windows = num_windows_for(chunk_size)
        if window_sharded(self.mesh.size, num_windows):
            partials = self._shard_buckets(smvp, tables, scalars, m,
                                           chunk_size, None)
            return self._tail_windows(partials, chunk_size)
        buckets = self._shard_buckets(smvp, tables, scalars, m,
                                      chunk_size, num_windows)
        return self._tail_tree(buckets, chunk_size)

    # -- the tail -------------------------------------------------------------

    def _tail_windows(self, partials, chunk_size: int) -> torch.Tensor:
        """Recursive halving of the window-major partial buckets, BPR on
        each shard's kw windows, the exit, the all-gather."""
        mesh, group = self.mesh, self.group
        num_windows = num_windows_for(chunk_size)
        h = 1 << (chunk_size - 1)
        cur, width, bit = partials, num_windows, mesh.size >> 1
        while bit:
            cut = width // 2 * h
            keeps, sends = [], []
            for i, c in enumerate(cur):
                low, high = c[:, :cut], c[:, cut:]
                keep_low = not mesh.index(i) & bit
                keeps.append((low if keep_low else high).contiguous())
                sends.append((high if keep_low else low).contiguous())
            recvs = self._exchange(sends, bit)
            cur = []
            for dev, keep, recv in zip(mesh.devices, keeps, recvs):
                with _on(dev):
                    cur.append(K.bpr_add(keep, recv, group))
            width //= 2
            bit >>= 1
        blocks = []
        for dev, c in zip(mesh.devices, cur):
            with _on(dev):
                order = self._bpr_order(width, chunk_size, dev)
                sums = self._bpr(c[:, order], chunk_size, width)
                blocks.append(mont_mul_const(sums, 1, group.ctx))
        return self._all_gather(blocks)

    def _tail_tree(self, buckets, chunk_size: int) -> torch.Tensor:
        """BPR on every shard, the window sums gathered and added up a tree
        on the first shard's device, one canon, the exit."""
        group = self.group
        num_windows = num_windows_for(chunk_size)
        sums = []
        for dev, b in zip(self.mesh.devices, buckets):
            with _on(dev):
                sums.append(self._bpr(b, chunk_size, num_windows))
        every = self._all_gather(sums)
        with _on(every.device):
            level = [every[:, d * num_windows:(d + 1) * num_windows]
                     for d in range(self.mesh.size)]
            while len(level) > 1:
                pairs = len(level) // 2
                added = K.bpr_add(torch.cat(level[0:2 * pairs:2], 1),
                                  torch.cat(level[1:2 * pairs:2], 1), group)
                level = [added[:, k * num_windows:(k + 1) * num_windows]
                         for k in range(pairs)] + level[2 * pairs:]
            acc = level[0].contiguous()
            if self.mesh.size > 1:
                acc = C.merge(group.canon(group.split(acc)))
            return mont_mul_const(acc, 1, group.ctx)

    def _exchange(self, sends: list[torch.Tensor], bit: int):
        """One halving round's exchange: local shard i receives, on its
        device, what shard index(i) ^ bit sends.  A peer in this process
        hands its tensor over (.to: nothing where the device is the same);
        a peer in another process goes through point-to-point ops, tagged
        with the sender's local index (as NCCL ignores tags, both sides
        also post them in local-index order)."""
        mesh = self.mesh
        recvs, ops = [], []
        for i, t in enumerate(sends):
            rank, j = divmod(mesh.index(i) ^ bit, mesh.local)
            if rank == mesh.rank:
                recvs.append(sends[j].to(mesh.devices[i]))
                continue
            peer = dist.get_global_rank(mesh.group, rank)
            buf = torch.empty_like(t)
            ops += [dist.P2POp(dist.isend, t, peer, mesh.group, tag=i),
                    dist.P2POp(dist.irecv, buf, peer, mesh.group, tag=j)]
            recvs.append(buf)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return recvs

    def _all_gather(self, planes: list[torch.Tensor]) -> torch.Tensor:
        """Local shards' planes of one width, then every process's, side
        by side in global shard order, on the first local device."""
        dev0 = self.mesh.devices[0]
        mine = torch.cat([p.to(dev0) for p in planes], dim=1)
        if self.mesh.group is None:
            return mine
        every = [torch.empty_like(mine) for _ in range(self.mesh.world_size)]
        dist.all_gather(every, mine, group=self.mesh.group)
        return torch.cat(every, dim=1)

    # -- entry points -----------------------------------------------------------

    def msm_device(self, points, scalars, chunk_size: int) -> torch.Tensor:
        """The sharded pipeline over prepared points and scalars (host words
        or tensors, and their layouts): the (39|36, num_windows) plain
        window sums, on the first local shard's device, in every
        process."""
        n_pad, m = self._padded(points[1].n)
        path = self._shard_path(chunk_size, m)
        tables = self._shard_prep(path, points, m)
        return self._set(self._smvp_fn(path, m), tables, scalars, m,
                         chunk_size)

    def compute_msm_batch(self, points: Any,
                          scalars_batch: Sequence[Any]) -> list[dict[str, int]]:
        """Batched MSM over a fixed point set on the mesh: the point prep
        once a shard, then per set its shards' plans and SMVPs and the
        tail, enqueued set after set; one readback, the host Horner."""
        points = self._prepare_points(points)
        n = points[1].n
        chunk_size = self._chunk_for(n)
        sws = self._check_sets(n, scalars_batch)
        if not sws:
            return []
        n_pad, m = self._padded(n)
        path = self._shard_path(chunk_size, m)
        smvp = self._smvp_fn(path, m, batch=True)
        tables = self._shard_prep(path, points, m)
        coords = [self._set(smvp, tables, sw, m, chunk_size)
                  for sw in sws]
        return self._batch_finish(coords, chunk_size)
