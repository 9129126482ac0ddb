"""Plain-bigint oracles: BLS12-377 G1 (short Weierstrass y^2 = x^3 + 1)
and Twisted Edwards BLS12 (a = -1, d = 3021).

The subset of the JAX package's reference/curve.py that the port needs:
G1 projective add-2002-bj / dbl-2007-bl, Edwards extended add-2008-hwcd /
dbl-2008-hwcd, double-and-add scalar multiplication and the affine
conversions.  Points live in the plain field domain.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..params import (
    BLS12_377_BASE_FIELD,
    BLS12_377_G1_GENERATOR_X,
    BLS12_377_G1_GENERATOR_Y,
    EDWARDS_BLS12_BASE_FIELD,
    EDWARDS_D,
    EDWARDS_GENERATOR_X,
    EDWARDS_GENERATOR_Y,
)

P = BLS12_377_BASE_FIELD
Q = EDWARDS_BLS12_BASE_FIELD


@dataclass(frozen=True)
class ProjectivePoint:
    """(X : Y : Z) projective point; the zero point has Z == 0."""

    x: int
    y: int
    z: int

    def is_zero(self) -> bool:
        return self.z % P == 0


G1_ZERO = ProjectivePoint(0, 1, 0)
G1_GENERATOR = ProjectivePoint(
    BLS12_377_G1_GENERATOR_X, BLS12_377_G1_GENERATOR_Y, 1
)


def g1_from_affine(x: int, y: int) -> ProjectivePoint:
    return ProjectivePoint(x % P, y % P, 1)


def g1_on_curve(pt: ProjectivePoint) -> bool:
    """Projective check Y^2 Z = X^3 + Z^3."""
    x, y, z = pt.x % P, pt.y % P, pt.z % P
    return (y * y * z - (x * x * x + z * z * z)) % P == 0


def g1_neg(pt: ProjectivePoint) -> ProjectivePoint:
    if pt.is_zero():
        return pt
    return ProjectivePoint(pt.x, (-pt.y) % P, pt.z)


def g1_add(p1: ProjectivePoint, p2: ProjectivePoint) -> ProjectivePoint:
    """Unified projective addition, add-2002-bj."""
    if p1.is_zero():
        return p2
    if p2.is_zero():
        return p1
    x1, y1, z1 = p1.x, p1.y, p1.z
    x2, y2, z2 = p2.x, p2.y, p2.z
    u1 = (x1 * z2) % P
    u2 = (x2 * z1) % P
    s1 = (y1 * z2) % P
    s2 = (y2 * z1) % P
    zz = (z1 * z2) % P
    t = (u1 + u2) % P
    m = (s1 + s2) % P
    r = (t * t - u1 * u2) % P
    f = (zz * m) % P
    l = (m * f) % P
    g = (t * l) % P
    w = (r * r - g) % P
    x3 = (2 * f * w) % P
    y3 = (r * (g - 2 * w) - l * l) % P
    z3 = (2 * f * f * f) % P
    return ProjectivePoint(x3, y3, z3)


def g1_double(p1: ProjectivePoint) -> ProjectivePoint:
    """Projective doubling, dbl-2007-bl (a = 0)."""
    x, y, z = p1.x, p1.y, p1.z
    xx = (x * x) % P
    w = (3 * xx) % P
    s = (2 * y * z) % P
    ss = (s * s) % P
    sss = (ss * s) % P
    r = (y * s) % P
    rr = (r * r) % P
    b = ((x + r) * (x + r) - xx - rr) % P
    h = (w * w - 2 * b) % P
    x3 = (h * s) % P
    y3 = (w * (b - h) - 2 * rr) % P
    return ProjectivePoint(x3, y3, sss)


def g1_scalar_mult(pt: ProjectivePoint, k: int) -> ProjectivePoint:
    """Double-and-add scalar multiplication."""
    if k < 0:
        return g1_scalar_mult(g1_neg(pt), -k)
    result = G1_ZERO
    addend = pt
    while k:
        if k & 1:
            result = g1_add(result, addend)
        addend = g1_double(addend)
        k >>= 1
    return result


def g1_to_affine(pt: ProjectivePoint) -> tuple[int, int]:
    """(X:Y:Z) -> (x, y); the zero point maps to (0, 1)."""
    if pt.is_zero():
        return (0, 1)
    zinv = pow(pt.z % P, P - 2, P)
    return ((pt.x * zinv) % P, (pt.y * zinv) % P)


def g1_eq(p1: ProjectivePoint, p2: ProjectivePoint) -> bool:
    if p1.is_zero() or p2.is_zero():
        return p1.is_zero() and p2.is_zero()
    return (
        (p1.x * p2.z - p2.x * p1.z) % P == 0
        and (p1.y * p2.z - p2.y * p1.z) % P == 0
    )


# ---------------------------------------------------------------------------
# Twisted Edwards BLS12: a x^2 + y^2 = 1 + d x^2 y^2 with a = -1, d = 3021
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ExtendedPoint:
    """Extended twisted Edwards coordinates (X : Y : T : Z), T = XY/Z."""

    x: int
    y: int
    t: int
    z: int


ED_ZERO = ExtendedPoint(0, 1, 0, 1)
ED_GENERATOR = ExtendedPoint(
    EDWARDS_GENERATOR_X,
    EDWARDS_GENERATOR_Y,
    (EDWARDS_GENERATOR_X * EDWARDS_GENERATOR_Y) % Q,
    1,
)


def ed_from_affine(x: int, y: int) -> ExtendedPoint:
    return ExtendedPoint(x % Q, y % Q, (x * y) % Q, 1)


def ed_neg(pt: ExtendedPoint) -> ExtendedPoint:
    return ExtendedPoint((-pt.x) % Q, pt.y, (-pt.t) % Q, pt.z)


def ed_add(p1: ExtendedPoint, p2: ExtendedPoint) -> ExtendedPoint:
    """Unified extended addition, add-2008-hwcd, complete for a = -1."""
    a = (p1.x * p2.x) % Q
    b = (p1.y * p2.y) % Q
    c = (EDWARDS_D * p1.t * p2.t) % Q
    d = (p1.z * p2.z) % Q
    e = ((p1.x + p1.y) * (p2.x + p2.y) - a - b) % Q
    f = (d - c) % Q
    g = (d + c) % Q
    h = (b + a) % Q  # b - a*a_curve with a_curve = -1
    return ExtendedPoint((e * f) % Q, (g * h) % Q, (e * h) % Q, (f * g) % Q)


def ed_double(p1: ExtendedPoint) -> ExtendedPoint:
    """Extended doubling, dbl-2008-hwcd (a = -1)."""
    a = (p1.x * p1.x) % Q
    b = (p1.y * p1.y) % Q
    c = (2 * p1.z * p1.z) % Q
    d = (-a) % Q
    e = ((p1.x + p1.y) * (p1.x + p1.y) - a - b) % Q
    g = (d + b) % Q
    f = (g - c) % Q
    h = (d - b) % Q
    return ExtendedPoint((e * f) % Q, (g * h) % Q, (e * h) % Q, (f * g) % Q)


def ed_scalar_mult(pt: ExtendedPoint, k: int) -> ExtendedPoint:
    if k < 0:
        return ed_scalar_mult(ed_neg(pt), -k)
    result = ED_ZERO
    addend = pt
    while k:
        if k & 1:
            result = ed_add(result, addend)
        addend = ed_double(addend)
        k >>= 1
    return result


def ed_to_affine(pt: ExtendedPoint) -> tuple[int, int]:
    zinv = pow(pt.z % Q, Q - 2, Q)
    return ((pt.x * zinv) % Q, (pt.y * zinv) % Q)


def ed_eq(p1: ExtendedPoint, p2: ExtendedPoint) -> bool:
    return (
        (p1.x * p2.z - p2.x * p1.z) % Q == 0
        and (p1.y * p2.z - p2.y * p1.z) % Q == 0
    )
