"""Fencing and steady-state timing.

PyTorch returns from a CUDA call before the device has run it, so a host
clock measures only the enqueue unless the device is synchronized first:
fence does that for the CUDA devices of the tensors it is given (and
nothing for CPU tensors, which are done when the call returns).
"""

from __future__ import annotations

import time

import torch


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fence(tree) -> None:
    """Wait until every CUDA device that holds a tensor of `tree` (a
    tensor, or lists, tuples and dicts of them) has finished its work."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def time_fn(fn, *args, iters: int = 5, warmup: int = 1) -> float:
    """Mean steady-state seconds per call of fn(*args), fenced."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    fence(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    fence(out)
    return (time.perf_counter() - t0) / iters
