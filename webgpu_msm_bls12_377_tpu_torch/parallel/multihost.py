"""Several processes, one mesh: the sharded engine over torch.distributed
(the JAX package's parallel/multihost.py).

Every process drives its local devices; torch.distributed joins the
processes, and the mesh of parallel/mesh.py spans every shard of every
process: the tail's halving rounds and its all-gather then cross
processes through the group (NCCL between CUDA devices, gloo between CPU
shards).  Each process holds the whole input and shards it by its own
rank, so nothing but bucket partials and window sums crosses processes,
and every process gets the result.

    # one process per device, e.g. under torchrun (RANK, WORLD_SIZE,
    # MASTER_ADDR, MASTER_PORT and LOCAL_RANK from its environment):
    from webgpu_msm_bls12_377_tpu_torch.parallel import multihost
    multihost.init()
    engine = multihost.make_engine(CurveId.BLS12_377)
    result = engine.compute_msm(points, scalars)   # same single-call API
    torch.distributed.destroy_process_group()

parallel/dryrun.py runs two processes of two CPU shards each on gloo.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..params import CurveId

#: this process's shard devices, set by init
_local_devices: list[torch.device] | None = None


def init(init_method: str | None = None, world_size: int | None = None,
         rank: int | None = None, backend: str | None = None,
         local_devices=None) -> None:
    """Join this process to the group of world_size processes as `rank`.

    Arguments left out come from torchrun's environment: RANK and
    WORLD_SIZE, and init_method "env://" (MASTER_ADDR, MASTER_PORT) where
    MASTER_ADDR is set.  local_devices are this process's shard devices:
    by default cuda:LOCAL_RANK where LOCAL_RANK is set, else every local
    CUDA device; there is no CPU fallback (give ["cpu"] * k for CPU
    shards).  The backend is NCCL for CUDA devices and gloo for the CPU;
    a CUDA mesh never takes gloo, and an NCCL failure is an error."""
    global _local_devices
    from .mesh import make_mesh

    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if init_method is None:
        if "MASTER_ADDR" not in env:
            raise ValueError("no init_method, and no MASTER_ADDR in the "
                             "environment (torchrun sets it)")
        init_method = "env://"
    if local_devices is None and "LOCAL_RANK" in env:
        local_devices = [f"cuda:{int(env['LOCAL_RANK'])}"]
    devices = make_mesh(local_devices).devices
    kind = devices[0].type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if (kind == "cuda") != (backend == "nccl"):
        raise ValueError(f"{kind} shards take "
                         f"{'nccl' if kind == 'cuda' else 'gloo'}, not "
                         f"{backend}")
    if kind == "cuda":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    _local_devices = devices


def global_mesh():
    """The mesh over every shard of every process of the default group."""
    from .mesh import make_mesh

    if _local_devices is None or not dist.is_initialized():
        raise RuntimeError("multihost.init has not joined a process group")
    return make_mesh(_local_devices, group=dist.group.WORLD)


def make_engine(curve: CurveId = CurveId.BLS12_377, **kw):
    """ShardedMsmEngine over the process-spanning global mesh."""
    from .mesh import ShardedMsmEngine

    return ShardedMsmEngine(curve, mesh=global_mesh(), **kw)
