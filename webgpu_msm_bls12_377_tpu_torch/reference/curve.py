"""Plain-bigint BLS12-377 G1 oracle (short Weierstrass y^2 = x^3 + 1).

The subset of the JAX package's reference/curve.py that the port needs:
projective add-2002-bj / dbl-2007-bl, double-and-add scalar
multiplication and the affine conversion.  Points live in the plain
field domain.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..params import (
    BLS12_377_BASE_FIELD,
    BLS12_377_G1_GENERATOR_X,
    BLS12_377_G1_GENERATOR_Y,
)

P = BLS12_377_BASE_FIELD


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
