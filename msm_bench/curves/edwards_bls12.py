"""Twisted Edwards BLS12 in plain Python arithmetic: -x^2 + y^2 = 1 +
d x^2 y^2 (a = -1, d = 3021) over the BLS12-377 scalar field, cofactor 4
(snarkVM's EdwardsBLS12).  The constants are the published ones (the same
values as the port's params.py, copied so that nothing here imports the
program).  Points are affine (x, y) pairs of ints; internally extended
coordinates (X : Y : T : Z)."""

from __future__ import annotations

from . import batch_invert
from .bls12_377 import BLS12_377_R

#: the field (the BLS12-377 scalar field), d, the generator and the order
#: of the prime subgroup
ED_Q = BLS12_377_R
ED_D = 3021
ED_GEN = (
    int("1540945439182663264862696551825005342995406165131907382295858612069623286213"),
    int("8003546896475222703853313610036801932325312921786952001586936882361378122196"),
)
ED_ORDER = int(
    "2111115437357092606062206234695386632838870926408408195193685246394721360383")


class Curve:
    """-x^2 + y^2 = 1 + d x^2 y^2 over F_q, q the BLS12-377 scalar field."""

    name = "edwards_bls12"
    p = ED_Q
    order = ED_ORDER
    gen = ED_GEN
    coord_bytes = 32
    zero = (0, 1, 0, 1)

    @classmethod
    def on_curve(cls, pt: tuple[int, int]) -> bool:
        x, y = pt
        q = cls.p
        xx, yy = x * x % q, y * y % q
        return (0 <= x < q and 0 <= y < q
                and (yy - xx - 1 - ED_D * xx * yy) % q == 0)

    @classmethod
    def lift(cls, pt):
        return (pt[0], pt[1], pt[0] * pt[1] % cls.p, 1)

    @classmethod
    def add(cls, a, b):
        """add-2008-hwcd (a = -1), complete on this curve."""
        x1, y1, t1, z1 = a
        x2, y2, t2, z2 = b
        q = cls.p
        aa = x1 * x2 % q
        bb = y1 * y2 % q
        cc = ED_D * t1 * t2 % q
        dd = z1 * z2 % q
        e = ((x1 + y1) * (x2 + y2) - aa - bb) % q
        f, g, h = (dd - cc) % q, (dd + cc) % q, (bb + aa) % q
        return (e * f % q, g * h % q, e * h % q, f * g % q)

    @classmethod
    def double(cls, a):
        return cls.add(a, a)

    @classmethod
    def madd(cls, a, x2: int, y2: int):
        return cls.add(a, (x2, y2, x2 * y2 % cls.p, 1))

    @classmethod
    def normalize(cls, pts) -> list[tuple[int, int]]:
        q = cls.p
        zinv = batch_invert([pt[3] for pt in pts], q)
        return [(pt[0] * zi % q, pt[1] * zi % q) for pt, zi in zip(pts, zinv)]

    @classmethod
    def to_affine(cls, a) -> tuple[int, int]:
        """The identity is (0, 1)."""
        return cls.normalize([a])[0]
