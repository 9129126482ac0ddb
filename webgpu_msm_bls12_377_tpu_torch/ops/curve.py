"""Point formulas, plain PyTorch: BLS12-377 G1 and Twisted Edwards BLS12,
each in the lazy and the canonical domain.

Complete projective formulas of Renes-Costello-Batina 2016 (a = 0,
b3 = 3) in Montgomery form, in the exact operation order of the JAX
package's ops/curve.py:G1Ops (the pair-REDC lazy forms, and the canonical
add / add_mixed / double).  csrc/curve.cuh runs the same sequences, so
kernel and plain outputs agree word for word.

Lazy forms: comments give value bounds in units of p ("b<=k": value <
k*p).  REDC outputs stay below 2p because R/p ~ 2^39 dwarfs every bound
product used here (at most 304); the largest raw value is 20p < 2^382.
Canonical forms (add, add_mixed, double) take and return coordinates
below p and reduce after every field operation.

A point batch is a ProjG1 of three (13, N) int32 planes; kernels take the
merged (39, N) plane (coordinate c at rows [13c, 13c + 13)).

EdwardsOps: the extended twisted-Edwards hwcd formulas (a = -1, d =
3021) over the 9-word Edwards field, in the exact operation order of the
JAX package's ops/curve.py:EdwardsOps (the lazy forms, and the canonical
add / add_mixed / double, complete for a = -1 with d a non-square, so no
lane needs an identity select); a point batch is an ExtEd of four (9, N)
planes (merged: (36, N)), an affine addend the triple (x, y, t = x*y)
(merged: (27, N)).  hwcd has no paired-product form.

Both classes carry the vocabulary the kernels' plain forms use: ctx,
rows / aff_rows, signed_coords, split / split_aff, zero, from_affine,
neg_affine, add_affine_lazy, add_mixed_lazy, add_lazy, double_lazy, canon,
select, and the canonical add, add_mixed, double, neg and is_zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..params import EDWARDS_D, CurveId
from . import field as F
from .field import ED_CTX, G1_CTX, NW, PARAMS

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
    """ProjG1 (or any coordinate tuple) -> merged (k*nw, N) plane."""
    n = max(c.shape[-1] for c in pt)
    return torch.cat([c.expand(c.shape[0], n) for c in pt],
                     dim=0).contiguous()


class G1Ops:
    """Batched lazy-domain G1 group ops over Montgomery word planes."""

    CURVE = CurveId.BLS12_377
    ctx = G1_CTX
    rows = N_COORDS * NW
    aff_rows = 2 * NW
    #: the affine coordinates that change sign with the point
    signed_coords = (1,)

    @staticmethod
    def split(plane: torch.Tensor) -> ProjG1:
        return split(plane)

    @staticmethod
    def split_aff(plane: torch.Tensor):
        """Merged (26, N) affine plane -> (x, y)."""
        return plane[:NW], plane[NW:]

    def zero(self, n: int, device=None) -> ProjG1:
        """The point at infinity (0 : 1 : 0), Montgomery form."""
        z = torch.zeros((NW, n), dtype=torch.int32, device=device)
        one = F.const_col(PARAMS.r, device).expand(NW, n).contiguous()
        return ProjG1(z, one, z.clone())

    def from_affine(self, aff) -> ProjG1:
        x, y = aff
        one = F.const_col(PARAMS.r, x.device).expand_as(x).contiguous()
        return ProjG1(x, y, one)

    @staticmethod
    def is_zero(p: ProjG1) -> torch.Tensor:
        """(N,) mask of the lanes at infinity (Z == 0)."""
        return F.is_zero(p.z)

    @staticmethod
    def neg_affine(aff):
        """(x, y) -> (x, -y) for canonical y."""
        x, y = aff
        return (x, F.field_neg(y))

    def neg(self, p: ProjG1) -> ProjG1:
        """(X : Y : Z) -> (X : -Y : Z) for canonical Y; lanes at infinity
        pass through, as in the JAX package."""
        return self.select(self.is_zero(p), p,
                           ProjG1(p.x, F.field_neg(p.y), p.z))

    def add_mixed_lazy(self, p1: ProjG1, aff) -> ProjG1:
        """Mixed add: accumulator < 4p, affine addend canonical and not the
        identity; outputs < 2p."""
        mm, mmp, fa = F.mont_mul, F.mont_mul_pair, F.lazy_add
        X1, Y1, Z1 = p1  # b<=4 each
        X2, Y2 = aff  # b<=1
        t0 = mm(X1, X2)                       # 4 -> b<=2
        t1 = mm(Y1, Y2)                       # 4 -> b<=2
        t3 = fa(X2, Y2)                       # b<=2
        t4 = fa(X1, Y1)                       # b<=8
        t3 = mm(t3, t4)                       # 16 -> b<=2
        t4 = fa(t0, t1)                       # b<=4
        t3 = F.lazy_sub(t3, t4, 4)            # b<=6
        t4 = mm(Y2, Z1)                       # 4 -> b<=2
        t4 = fa(t4, Y1)                       # b<=6
        Y3 = mm(X2, Z1)                       # 4 -> b<=2
        Y3 = fa(Y3, X1)                       # b<=6
        t0 = F.lazy_triple(t0)                # b<=6
        t2 = F.lazy_triple(Z1)                # b<=12
        Z3 = fa(t1, t2)                       # b<=14
        t1 = F.lazy_sub(t1, t2, 12)           # b<=14
        Y3 = F.lazy_triple(Y3)                # b<=18
        t4n = F.lazy_neg(t4, 6)               # 6p - t4; b<=6
        # X3 = t3*t1 - t4*Y3, Y3 = t1*Z3 + Y3*t0, Z3 = Z3*t4 + t0*t3
        X3 = mmp(t3, t1, t4n, Y3)             # 6*14 + 6*18 = 192 -> b<=2
        Y3n = mmp(t1, Z3, Y3, t0)             # 14*14 + 18*6 = 304 -> b<=2
        Z3 = mmp(Z3, t4, t0, t3)              # 14*6 + 6*6 = 120 -> b<=2
        return ProjG1(X3, Y3n, Z3)

    def add_affine_lazy(self, aff1, aff2) -> ProjG1:
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

    def add_lazy(self, p1: ProjG1, p2: ProjG1) -> ProjG1:
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

    # -- canonical domain (coordinates < p in, < p out) ----------------------

    @staticmethod
    def _triple(v):
        return F.field_add(F.field_add(v, v), v)

    def add(self, p1: ProjG1, p2: ProjG1) -> ProjG1:
        """Complete projective add (RCB Alg. 7): 12 products."""
        mm, fa, fs = F.mont_mul_canon, F.field_add, F.field_sub
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        t0 = mm(X1, X2); t1 = mm(Y1, Y2); t2 = mm(Z1, Z2)
        t3 = fa(X1, Y1); t4 = fa(X2, Y2); t3 = mm(t3, t4)
        t4 = fa(t0, t1); t3 = fs(t3, t4); t4 = fa(Y1, Z1)
        X3 = fa(Y2, Z2); t4 = mm(t4, X3); X3 = fa(t1, t2)
        t4 = fs(t4, X3); X3 = fa(X1, Z1); Y3 = fa(X2, Z2)
        X3 = mm(X3, Y3); Y3 = fa(t0, t2); Y3 = fs(X3, Y3)
        t0 = self._triple(t0); t2 = self._triple(t2)
        Z3 = fa(t1, t2); t1 = fs(t1, t2); Y3 = self._triple(Y3)
        X3 = mm(t4, Y3); t2 = mm(t3, t1); X3 = fs(t2, X3)
        Y3 = mm(Y3, t0); t1 = mm(t1, Z3); Y3 = fa(t1, Y3)
        t0 = mm(t0, t3); Z3 = mm(Z3, t4); Z3 = fa(Z3, t0)
        return ProjG1(X3, Y3, Z3)

    def add_mixed(self, p1: ProjG1, aff) -> ProjG1:
        """Complete mixed add (RCB Alg. 8): 11 products.  The affine addend
        must not be the identity; the accumulator may be."""
        mm, fa, fs = F.mont_mul_canon, F.field_add, F.field_sub
        X1, Y1, Z1 = p1
        X2, Y2 = aff
        t0 = mm(X1, X2); t1 = mm(Y1, Y2); t3 = fa(X2, Y2)
        t4 = fa(X1, Y1); t3 = mm(t3, t4); t4 = fa(t0, t1)
        t3 = fs(t3, t4); t4 = mm(Y2, Z1); t4 = fa(t4, Y1)
        Y3 = mm(X2, Z1); Y3 = fa(Y3, X1)
        t0 = self._triple(t0); t2 = self._triple(Z1); Z3 = fa(t1, t2)
        t1 = fs(t1, t2); Y3 = self._triple(Y3); X3 = mm(t4, Y3)
        t2 = mm(t3, t1); X3 = fs(t2, X3); Y3 = mm(Y3, t0)
        t1 = mm(t1, Z3); Y3 = fa(t1, Y3); t0 = mm(t0, t3)
        Z3 = mm(Z3, t4); Z3 = fa(Z3, t0)
        return ProjG1(X3, Y3, Z3)

    def double(self, p: ProjG1) -> ProjG1:
        """Complete doubling (RCB Alg. 9): 8 products."""
        mm, fa, fs = F.mont_mul_canon, F.field_add, F.field_sub
        X, Y, Z = p
        t0 = mm(Y, Y); Z3 = fa(t0, t0); Z3 = fa(Z3, Z3)
        Z3 = fa(Z3, Z3); t1 = mm(Y, Z); t2 = mm(Z, Z)
        t2 = self._triple(t2); X3 = mm(t2, Z3); Y3 = fa(t0, t2)
        Z3 = mm(t1, Z3); t2 = self._triple(t2)
        t0 = fs(t0, t2); Y3 = mm(t0, Y3); Y3 = fa(X3, Y3)
        t1 = mm(X, Y); X3 = mm(t0, t1); X3 = fa(X3, X3)
        return ProjG1(X3, Y3, Z3)

    def canon(self, p: ProjG1) -> ProjG1:
        """Lazy point (coords < 4p) -> canonical coords (< p)."""
        return ProjG1(*(F.field_canon(c, LAZY_BOUND) for c in p))

    @staticmethod
    def select(mask: torch.Tensor, a, b) -> ProjG1:
        """Lane-wise a where mask (N,) else b."""
        return ProjG1(*(torch.where(mask[None], ca, cb) for ca, cb in zip(a, b)))


# ---------------------------------------------------------------------------
# Twisted Edwards BLS12 (a = -1, d = 3021): unified hwcd formulas
# ---------------------------------------------------------------------------


class ExtEd(NamedTuple):
    """Extended (X : Y : T : Z) point batch, T = XY/Z; zero is (0 : 1 : 0 : 1)."""

    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    z: torch.Tensor


class EdwardsOps:
    """Batched Edwards group ops over Montgomery word planes, lazy and
    canonical.

    Lazy forms (comments: "b<=k", value < k*p): every coordinate handed on
    is below 2p (LAZY_BOUND), affine addends are canonical.  REDC outputs
    stay below 2p because R/p ~ 5.9e10 dwarfs every bound product here (at
    most 48); the largest raw value is 8p < 2^256.  lazy_sub(a, b, k) is
    a + k*p - b, the same as the JAX package's lazy_sub with its k*p
    column mod p."""

    CURVE = CurveId.EDWARDS_BLS12
    ctx = ED_CTX
    N_COORDS = 4
    LAZY_BOUND = 2
    rows = 4 * ED_CTX.nw
    aff_rows = 3 * ED_CTX.nw
    signed_coords = (0, 2)

    @staticmethod
    def split(plane: torch.Tensor) -> ExtEd:
        """Merged (36, N) plane -> ExtEd of (9, N) views."""
        nw = ED_CTX.nw
        return ExtEd(*(plane[c * nw:(c + 1) * nw] for c in range(4)))

    @staticmethod
    def split_aff(plane: torch.Tensor):
        """Merged (27, N) affine plane -> (x, y, t)."""
        nw = ED_CTX.nw
        return tuple(plane[c * nw:(c + 1) * nw] for c in range(3))

    def _d(self, device) -> torch.Tensor:
        return ED_CTX.col(EDWARDS_D * ED_CTX.params.r % ED_CTX.p, device)

    def zero(self, n: int, device=None) -> ExtEd:
        """The identity (0 : 1 : 0 : 1), Montgomery form."""
        z = torch.zeros((ED_CTX.nw, n), dtype=torch.int32, device=device)
        one = ED_CTX.col(ED_CTX.params.r, device).expand(ED_CTX.nw, n)
        return ExtEd(z, one.contiguous(), z.clone(), one.contiguous())

    def from_affine(self, aff) -> ExtEd:
        x, y, t = aff
        one = ED_CTX.col(ED_CTX.params.r, x.device).expand_as(x).contiguous()
        return ExtEd(x, y, t, one)

    @staticmethod
    def neg_affine(aff):
        """(x, y, t) -> (-x, y, -t) for canonical x, t."""
        x, y, t = aff
        return (F.field_neg(x, ED_CTX), y, F.field_neg(t, ED_CTX))

    def add_mixed_lazy(self, p1: ExtEd, aff) -> ExtEd:
        """Unified mixed add: accumulator < 2p, affine addend canonical;
        outputs < 2p."""
        ctx = ED_CTX
        mm = lambda u, v: F.mont_mul(u, v, ctx)  # noqa: E731
        fa = F.lazy_add
        x2, y2, t2 = aff                      # b<=1
        a = mm(p1.x, x2)                      # 2 -> b<=2
        b = mm(p1.y, y2)                      # 2 -> b<=2
        t1t2 = mm(p1.t, t2)                   # 2 -> b<=2
        c = mm(self._d(x2.device), t1t2)      # 2 -> b<=2
        x1y1 = fa(p1.x, p1.y)                 # b<=4
        x2y2 = fa(x2, y2)                     # b<=2
        em = mm(x1y1, x2y2)                   # 8 -> b<=2
        ab = fa(a, b)                         # b<=4
        e = F.lazy_sub(em, ab, 4, ctx)        # b<=6
        dd = p1.z                             # b<=2 (z2 = 1)
        f = F.lazy_sub(dd, c, 2, ctx)         # b<=4
        g = fa(dd, c)                         # b<=4
        h = fa(b, a)                          # b<=4
        return ExtEd(mm(e, f),                # 24 -> b<=2
                     mm(g, h),                # 16 -> b<=2
                     mm(e, h),                # 24 -> b<=2
                     mm(f, g))                # 16 -> b<=2

    def add_affine_lazy(self, aff1, aff2) -> ExtEd:
        """Both-affine add (tree level 1): add_mixed_lazy seeded with the
        promoted first addend, as the JAX package's add_affine_lazy."""
        return self.add_mixed_lazy(self.from_affine(aff1), aff2)

    def add_lazy(self, p1: ExtEd, p2: ExtEd) -> ExtEd:
        """Unified full add: inputs < 2p, outputs < 2p (closed)."""
        ctx = ED_CTX
        mm = lambda u, v: F.mont_mul(u, v, ctx)  # noqa: E731
        fa = F.lazy_add
        a = mm(p1.x, p2.x)                    # 4 -> b<=2
        b = mm(p1.y, p2.y)                    # 4 -> b<=2
        t1t2 = mm(p1.t, p2.t)                 # 4 -> b<=2
        c = mm(self._d(a.device), t1t2)       # 2 -> b<=2
        x1y1 = fa(p1.x, p1.y)                 # b<=4
        x2y2 = fa(p2.x, p2.y)                 # b<=4
        em = mm(x1y1, x2y2)                   # 16 -> b<=2
        ab = fa(a, b)                         # b<=4
        e = F.lazy_sub(em, ab, 4, ctx)        # b<=6
        dd = mm(p1.z, p2.z)                   # 4 -> b<=2
        f = F.lazy_sub(dd, c, 2, ctx)         # b<=4
        g = fa(dd, c)                         # b<=4
        h = fa(b, a)                          # b<=4
        return ExtEd(mm(e, f),                # 24 -> b<=2
                     mm(g, h),                # 16 -> b<=2
                     mm(e, h),                # 24 -> b<=2
                     mm(f, g))                # 16 -> b<=2

    def double_lazy(self, p1: ExtEd) -> ExtEd:
        """dbl-2008-hwcd (a = -1): input < 2p, outputs < 2p (closed)."""
        ctx = ED_CTX
        mm = lambda u, v: F.mont_mul(u, v, ctx)  # noqa: E731
        fa = F.lazy_add
        a = mm(p1.x, p1.x)                    # 4 -> b<=2
        b = mm(p1.y, p1.y)                    # 4 -> b<=2
        zz = mm(p1.z, p1.z)                   # 4 -> b<=2
        c = fa(zz, zz)                        # b<=4
        d = F.lazy_neg(a, 2, ctx)             # 2p - a; b<=2
        xy = fa(p1.x, p1.y)                   # b<=4
        e = mm(xy, xy)                        # 16 -> b<=2
        e = F.lazy_sub(e, fa(a, b), 4, ctx)   # b<=6
        g = fa(d, b)                          # b<=4
        f = F.lazy_sub(g, c, 4, ctx)          # b<=8
        h = F.lazy_sub(d, b, 2, ctx)          # b<=4
        return ExtEd(mm(e, f),                # 48 -> b<=2
                     mm(g, h),                # 16 -> b<=2
                     mm(e, h),                # 24 -> b<=2
                     mm(f, g))                # 32 -> b<=2

    def canon(self, p: ExtEd) -> ExtEd:
        """Lazy point (coords < 2p) -> canonical coords: one conditional
        subtract of p each."""
        return ExtEd(*(F.field_canon(c, self.LAZY_BOUND, ED_CTX) for c in p))

    # -- canonical domain (coordinates < p in, < p out) ----------------------

    @staticmethod
    def is_zero(p: ExtEd) -> torch.Tensor:
        """(N,) mask of the identity lanes (x == 0 and y == z), canonical
        coordinates."""
        return F.is_zero(p.x) & F.is_zero(F.field_sub(p.y, p.z, ED_CTX))

    @staticmethod
    def neg(p: ExtEd) -> ExtEd:
        """(x : y : t : z) -> (-x : y : -t : z) for canonical x, t."""
        return ExtEd(F.field_neg(p.x, ED_CTX), p.y, F.field_neg(p.t, ED_CTX),
                     p.z)

    def _add_core(self, p1: ExtEd, p2, dd) -> ExtEd:
        """add-2008-hwcd with a = -1 folded in (h = b + a), dd the z-term;
        canonical throughout."""
        ctx = ED_CTX
        mm = lambda u, v: F.mont_mul_canon(u, v, ctx)  # noqa: E731
        fa = lambda u, v: F.field_add(u, v, ctx)  # noqa: E731
        fs = lambda u, v: F.field_sub(u, v, ctx)  # noqa: E731
        x2, y2, t2 = p2[:3]
        a = mm(p1.x, x2)
        b = mm(p1.y, y2)
        c = mm(self._d(a.device), mm(p1.t, t2))
        e = fs(fs(mm(fa(p1.x, p1.y), fa(x2, y2)), a), b)
        f = fs(dd, c)
        g = fa(dd, c)
        h = fa(b, a)
        return ExtEd(mm(e, f), mm(g, h), mm(e, h), mm(f, g))

    def add(self, p1: ExtEd, p2: ExtEd) -> ExtEd:
        """Complete extended add: 10 products."""
        return self._add_core(p1, p2, F.mont_mul_canon(p1.z, p2.z, ED_CTX))

    def add_mixed(self, p1: ExtEd, aff) -> ExtEd:
        """Complete mixed add of an affine (x, y, t) addend (z2 = 1: the
        z-term is z1): 9 products."""
        return self._add_core(p1, aff, p1.z)

    def double(self, p1: ExtEd) -> ExtEd:
        """dbl-2008-hwcd (a = -1, d-term -a): 8 products."""
        ctx = ED_CTX
        mm = lambda u, v: F.mont_mul_canon(u, v, ctx)  # noqa: E731
        fa = lambda u, v: F.field_add(u, v, ctx)  # noqa: E731
        fs = lambda u, v: F.field_sub(u, v, ctx)  # noqa: E731
        a = mm(p1.x, p1.x)
        b = mm(p1.y, p1.y)
        zz = mm(p1.z, p1.z)
        c = fa(zz, zz)
        d = F.field_neg(a, ctx)
        xy = fa(p1.x, p1.y)
        e = fs(fs(mm(xy, xy), a), b)
        g = fa(d, b)
        f = fs(g, c)
        h = fs(d, b)
        return ExtEd(mm(e, f), mm(g, h), mm(e, h), mm(f, g))

    @staticmethod
    def select(mask: torch.Tensor, a, b) -> ExtEd:
        """Lane-wise a where mask (N,) else b."""
        return ExtEd(*(torch.where(mask[None], ca, cb) for ca, cb in zip(a, b)))


G1 = G1Ops()
EDWARDS = EdwardsOps()


def group_ops(curve: CurveId):
    """The group ops of a curve (the JAX package's group_ops)."""
    return G1 if curve == CurveId.BLS12_377 else EDWARDS
