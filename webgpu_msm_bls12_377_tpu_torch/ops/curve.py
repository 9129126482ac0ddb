"""BLS12-377 G1 point formulas in the lazy domain, plain PyTorch.

Complete projective formulas of Renes-Costello-Batina 2016 (a = 0,
b3 = 3) in Montgomery form, in the exact operation order of the JAX
package's ops/curve.py:G1Ops pair-REDC forms.  csrc/curve.cuh runs the
same sequence, so kernel and plain outputs agree word for word.

Comments give value bounds in units of p ("b<=k": value < k*p).  REDC
outputs stay below 2p because R/p ~ 2^39 dwarfs every bound product used
here (at most 264); the largest raw value is 20p < 2^382.

A point batch is a ProjG1 of three (13, N) int32 planes; kernels take the
merged (39, N) plane (coordinate c at rows [13c, 13c + 13)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import field as F
from .field import NW, PARAMS

#: lazy-domain bound of every point coordinate the formulas hand on
LAZY_BOUND = 4
N_COORDS = 3


class ProjG1(NamedTuple):
    """(X : Y : Z) projective point batch; zero encoded as Z == 0."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def split(plane: torch.Tensor) -> ProjG1:
    """Merged (39, N) plane -> ProjG1 of (13, N) views."""
    return ProjG1(*(plane[c * NW : (c + 1) * NW] for c in range(N_COORDS)))


def merge(pt) -> torch.Tensor:
    """ProjG1 (or any coordinate tuple) -> merged (k*13, N) plane."""
    n = max(c.shape[-1] for c in pt)
    return torch.cat([c.expand(NW, n) for c in pt], dim=0).contiguous()


class G1Ops:
    """Batched lazy-domain G1 group ops over Montgomery word planes."""

    def zero(self, n: int, device=None) -> ProjG1:
        """The point at infinity (0 : 1 : 0), Montgomery form."""
        z = torch.zeros((NW, n), dtype=torch.int32, device=device)
        one = F.const_col(PARAMS.r, device).expand(NW, n).contiguous()
        return ProjG1(z, one, z.clone())

    def from_affine(self, aff) -> ProjG1:
        x, y = aff
        one = F.const_col(PARAMS.r, x.device).expand_as(x).contiguous()
        return ProjG1(x, y, one)

    def add_affine_lazy_pair(self, aff1, aff2) -> ProjG1:
        """Both-affine add (Z1 = Z2 = 1): canonical inputs, outputs < 2p."""
        mm, mmp, fa = F.mont_mul, F.mont_mul_pair, F.lazy_add
        X1, Y1 = aff1  # b<=1
        X2, Y2 = aff2  # b<=1
        t2 = F.const_col(3 * PARAMS.r % PARAMS.p, X1.device)  # 3*Z1; b<=1
        t0 = mm(X1, X2)                       # -> b<=2
        t1 = mm(Y1, Y2)                       # -> b<=2
        t3 = fa(X2, Y2)                       # b<=2
        t4 = fa(X1, Y1)                       # b<=2
        t3 = mm(t3, t4)                       # 4  -> b<=2
        t4 = fa(t0, t1)                       # b<=4
        t3 = F.lazy_sub(t3, t4, 4)            # b<=6
        t4 = fa(Y2, Y1)                       # b<=2
        Y3 = fa(X2, X1)                       # b<=2
        t0 = F.lazy_triple(t0)                # b<=6
        Z3 = fa(t1, t2)                       # b<=3
        t1 = F.lazy_sub(t1, t2, 2)            # b<=4
        Y3 = F.lazy_triple(Y3)                # b<=6
        t4n = F.lazy_neg(t4, 4)               # 4p - t4; b<=4
        # X3 = t3*t1 - t4*Y3, Y3 = t1*Z3 + Y3*t0, Z3 = Z3*t4 + t0*t3
        X3 = mmp(t3, t1, t4n, Y3)             # 48 -> b<=2
        Y3n = mmp(t1, Z3, Y3, t0)             # 48 -> b<=2
        Z3 = mmp(Z3, t4, t0, t3)              # 42 -> b<=2
        return ProjG1(X3, Y3n, Z3)

    def add_lazy_pair(self, p1: ProjG1, p2: ProjG1) -> ProjG1:
        """Full projective add: inputs < 4p, outputs < 2p (closed)."""
        mm, mmp, fa = F.mont_mul, F.mont_mul_pair, F.lazy_add
        X1, Y1, Z1 = p1  # b<=4 each
        X2, Y2, Z2 = p2  # b<=4 each
        t0 = mm(X1, X2)                       # 16 -> b<=2
        t1 = mm(Y1, Y2)                       # 16 -> b<=2
        t2 = mm(Z1, Z2)                       # 16 -> b<=2
        t3 = fa(X1, Y1)                       # b<=8
        t4 = fa(X2, Y2)                       # b<=8
        t3 = mm(t3, t4)                       # 64 -> b<=2
        t4 = fa(t0, t1)                       # b<=4
        t3 = F.lazy_sub(t3, t4, 4)            # b<=6
        t4 = fa(Y1, Z1)                       # b<=8
        X3 = fa(Y2, Z2)                       # b<=8
        t4 = mm(t4, X3)                       # 64 -> b<=2
        X3 = fa(t1, t2)                       # b<=4
        t4 = F.lazy_sub(t4, X3, 4)            # b<=6
        X3 = fa(X1, Z1)                       # b<=8
        Y3 = fa(X2, Z2)                       # b<=8
        X3 = mm(X3, Y3)                       # 64 -> b<=2
        Y3 = fa(t0, t2)                       # b<=4
        Y3 = F.lazy_sub(X3, Y3, 4)            # b<=6
        t0 = F.lazy_triple(t0)                # b<=6
        t2 = F.lazy_triple(t2)                # b<=6
        Z3 = fa(t1, t2)                       # b<=8
        t1 = F.lazy_sub(t1, t2, 6)            # b<=8
        Y3 = F.lazy_triple(Y3)                # b<=18
        t4n = F.lazy_neg(t4, 12)              # 12p - t4; b<=12
        # X3 = t3*t1 - t4*Y3, Y3 = t1*Z3 + Y3*t0, Z3 = Z3*t4 + t0*t3
        X3 = mmp(t3, t1, t4n, Y3)             # 6*8 + 12*18 = 264 -> b<=2
        Y3n = mmp(t1, Z3, Y3, t0)             # 8*8 + 18*6 = 172 -> b<=2
        Z3 = mmp(Z3, t4, t0, t3)              # 8*6 + 6*6 = 84 -> b<=2
        return ProjG1(X3, Y3n, Z3)

    def double_lazy(self, p1: ProjG1) -> ProjG1:
        """Complete doubling: input < 4p, outputs < 4p (closed)."""
        mm, fa = F.mont_mul, F.lazy_add
        X, Y, Z = p1  # b<=4
        t0 = mm(Y, Y)                         # 16 -> b<=2
        Z3 = F.lazy_scale(t0, 8)              # b<=16
        t1 = mm(Y, Z)                         # 16 -> b<=2
        t2 = mm(Z, Z)                         # 16 -> b<=2
        t2 = F.lazy_triple(t2)                # b<=6
        X3 = mm(t2, Z3)                       # 96 -> b<=2
        Y3 = fa(t0, t2)                       # b<=8
        Z3 = mm(t1, Z3)                       # 32 -> b<=2
        t2 = F.lazy_triple(t2)                # b<=18
        t0 = F.lazy_sub(t0, t2, 18)           # b<=20
        Y3 = mm(t0, Y3)                       # 160 -> b<=2
        Y3 = fa(X3, Y3)                       # b<=4
        t1 = mm(X, Y)                         # 16 -> b<=2
        X3 = mm(t0, t1)                       # 40 -> b<=2
        X3 = fa(X3, X3)                       # b<=4
        return ProjG1(X3, Y3, Z3)

    def canon(self, p: ProjG1) -> ProjG1:
        """Lazy point (coords < 4p) -> canonical coords (< p)."""
        return ProjG1(*(F.field_canon(c, LAZY_BOUND) for c in p))

    @staticmethod
    def select(mask: torch.Tensor, a, b) -> ProjG1:
        """Lane-wise a where mask (N,) else b."""
        return ProjG1(*(torch.where(mask[None], ca, cb) for ca, cb in zip(a, b)))
