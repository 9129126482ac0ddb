"""Multi-process dry run of the sharded engine on the CPU (the JAX
package's tools/dryrun_multihost.py): two processes of two CPU shards
each (D = 4) on gloo, joined through a file:// rendezvous in a temporary
directory (no port to collide with another run on the host); the shards
take the hybrid tree.

Each process runs one compute_msm of N points (not a multiple of D: the
padding reaches every shard) and one compute_msm_batch of two sets, at
chunk 4 (64 windows: the window-sharded tail, whose first halving round
crosses the processes and whose second stays inside each), checks both
against the bigint oracle, prints "OK rank <r>" and leaves the group.

    python -m webgpu_msm_bls12_377_tpu_torch.parallel.dryrun

exits 0 where both processes printed OK within --timeout seconds.
"""

from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys
import tempfile
from pathlib import Path

PROCESSES, LOCAL_SHARDS, N = 2, 2, 30


def worker(rank: int, world: int, init_method: str) -> None:
    import torch
    import torch.distributed as dist

    from . import multihost
    from ..reference import curve as crv
    from ..reference.msm import G1, naive_msm

    torch.set_num_threads(1)
    multihost.init(init_method=init_method, world_size=world, rank=rank,
                   local_devices=["cpu"] * LOCAL_SHARDS)
    try:
        eng = multihost.make_engine(chunk_size=4, num_bpr_threads=4,
                                    smvp_mode="tree", tree_finish=2,
                                    autotune=False)
        assert eng.mesh.size == world * LOCAL_SHARDS, eng.mesh.size
        rng = random.Random("dryrun")  # the same inputs in every process
        pts = [crv.g1_scalar_mult(crv.G1_GENERATOR, rng.randrange(1, 1 << 60))
               for _ in range(N)]
        aff = [crv.g1_to_affine(p) for p in pts]
        sets = [[rng.randrange(0, 1 << 253) for _ in range(N)]
                for _ in range(2)]
        want = [crv.g1_to_affine(naive_msm(pts, s, G1)) for s in sets]
        got = eng.compute_msm(aff, sets[0])
        assert (got["x"], got["y"]) == want[0], f"rank {rank}: compute_msm"
        batch = eng.compute_msm_batch(aff, sets)
        assert [(g["x"], g["y"]) for g in batch] == want, (
            f"rank {rank}: compute_msm_batch")
        print(f"OK rank {rank}", flush=True)
    finally:
        dist.destroy_process_group()


def run(timeout: float = 300.0) -> int:
    """Spawn the processes, wait for them (killed at the timeout), print
    their output; 0 where every one printed OK."""
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    # gloo between processes of this host: the loopback interface
    if sys.platform.startswith("linux"):
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(prefix="msm_dryrun_") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "--worker", str(r), init],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(PROCESSES)]
        ok = True
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                out += f"\nrank {r}: killed after {timeout} s"
            print(out, end="" if out.endswith("\n") else "\n", flush=True)
            ok &= p.returncode == 0 and f"OK rank {r}" in out
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", nargs=2, metavar=("RANK", "INIT_METHOD"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    if args.worker:
        worker(int(args.worker[0]), PROCESSES, args.worker[1])
        return 0
    return run(args.timeout)


if __name__ == "__main__":
    sys.exit(main())
