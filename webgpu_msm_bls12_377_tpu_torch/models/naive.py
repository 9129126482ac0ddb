"""Naive device MSM: per-point double-and-add, then a tree sum.

The baseline engine of the JAX package's models/naive.py: every point is
multiplied by its scalar with the double-and-add over the scalar's 256
bits, least significant first (the JAX package's 256 steps of
masked_add_and_double; here one launch of kernel 7's scalar_mult, one
thread a lane's whole chain), then the products are folded with the JAX
package's log-depth tree (log2 N levels of its fused_add; here one launch
of kernel 7's tree_sum, which reads the plane in place) and leave the
Montgomery domain through kernel 1, whose point prep also made the
Montgomery table.  It costs ~256 point operations per point against the
cuZK pipeline's ~16, and is a correctness and throughput baseline only.
All of it runs in the canonical domain, for either curve (the group picks
the planes and the kernels' builds).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import curve as C
from ..ops.convert import WireLayout
from ..ops.kernels import (
    PLANE,
    SCALAR_BITS,
    mont_mul_const,
    point_prep,
    scalar_mult,
    tree_sum,
)
from ..params import CurveId
from .cuzk import resolve_device, words_to_device

G1 = C.G1


def batched_scalar_mult(table: torch.Tensor, scalar_words: torch.Tensor,
                        group=G1):
    """k_i * P_i for every lane: table the Montgomery affine plane (G1
    (26, N) (x; y), Edwards (27, N) (x; y; t)), scalar_words (8, N) int32
    (the u32 bits).  Returns the (39|36, N) canonical plane."""
    return scalar_mult(table, scalar_words, SCALAR_BITS, group)


class NaiveMsmEngine:
    """Baseline MSM engine for one curve: build_fn() gives the device
    function, as the JAX class does."""

    def __init__(self, curve: CurveId = CurveId.BLS12_377, *, device=None):
        self.curve = curve
        self.group = C.group_ops(curve)
        self.device = resolve_device(device)

    def build_fn(self):
        """fn(point_words (2, 12|8, N) uint32, scalar_words (8, N) uint32),
        host arrays, N a power of two -> the (39|36, 1) canonical sum (G1
        projective, Edwards extended) in plain (non-Montgomery) form, on
        the device."""
        group = self.group

        def fn(point_words: np.ndarray, scalar_words: np.ndarray):
            layout = WireLayout.of(point_words, False, group.ctx.nw - 1, 2)
            table = point_prep(words_to_device(point_words, self.device),
                               layout, group, PLANE)
            sw = words_to_device(scalar_words, self.device)
            total = tree_sum(batched_scalar_mult(table, sw, group), group)
            return mont_mul_const(total, 1, group.ctx)

        return fn
