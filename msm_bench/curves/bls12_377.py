"""BLS12-377 G1 in plain Python arithmetic: y^2 = x^3 + 1 over the
377-bit base field; the order of its prime subgroup is the 253-bit scalar
field.  The constants are the published ones (the same values as the
port's params.py, copied so that nothing here imports the program).
Points are affine (x, y) pairs of ints; internally Jacobian coordinates
(x = X / Z^2, y = Y / Z^3)."""

from __future__ import annotations

from . import batch_invert

#: BLS12-377 base field (377 bits) and scalar field (253 bits), the order
#: of G1's prime subgroup
BLS12_377_P = int(
    "0x01ae3a4617c510eac63b05c06ca1493b1a22d9f300f5138f1ef3622fba0948001"
    "70b5d44300000008508c00000000001", 16)
BLS12_377_R = int(
    "0x12ab655e9a2ca55660b44d1e5c37b00159aa76fed00000010a11800000000001", 16)
G1_GEN = (
    int("81937999373150964239938255573465948239988671502647976594219695644855"
        "304257327692006745978603320413799295628339695"),
    int("241266749859715473739788878240585681733927191168601896383759122102112"
        "907357779751001206799952863815012735208165030"),
)


class Curve:
    """y^2 = x^3 + 1 over F_p, p the BLS12-377 base field."""

    name = "bls12_377"
    p = BLS12_377_P
    order = BLS12_377_R
    gen = G1_GEN
    coord_bytes = 48
    zero = (1, 1, 0)  # Jacobian point at infinity

    @classmethod
    def on_curve(cls, pt: tuple[int, int]) -> bool:
        x, y = pt
        p = cls.p
        return 0 <= x < p and 0 <= y < p and (y * y - x * x * x - 1) % p == 0

    @classmethod
    def lift(cls, pt):
        return (pt[0], pt[1], 1)

    @classmethod
    def double(cls, a):
        """dbl-2009-l (a = 0)."""
        x1, y1, z1 = a
        if z1 == 0 or y1 == 0:
            return cls.zero
        p = cls.p
        aa = x1 * x1 % p
        bb = y1 * y1 % p
        cc = bb * bb % p
        d = 2 * ((x1 + bb) ** 2 - aa - cc) % p
        e = 3 * aa % p
        x3 = (e * e - 2 * d) % p
        return (x3, (e * (d - x3) - 8 * cc) % p, 2 * y1 * z1 % p)

    @classmethod
    def madd(cls, a, x2: int, y2: int):
        """madd-2007-bl: a Jacobian point plus an affine one.  Raises where
        the formula does not apply (a at infinity, a = +-(x2, y2)); the
        fixed bases' sums never meet those cases."""
        x1, y1, z1 = a
        p = cls.p
        z1z1 = z1 * z1 % p
        u2 = x2 * z1z1 % p
        s2 = y2 * z1 * z1z1 % p
        h = (u2 - x1) % p
        if h == 0 or z1 == 0:
            raise ArithmeticError("madd: an exceptional case")
        hh = h * h % p
        i = 4 * hh % p
        j = h * i % p
        r = 2 * (s2 - y1) % p
        v = x1 * i % p
        x3 = (r * r - j - 2 * v) % p
        return (x3, (r * (v - x3) - 2 * y1 * j) % p,
                ((z1 + h) ** 2 - z1z1 - hh) % p)

    @classmethod
    def add(cls, a, b):
        """Jacobian addition, add-2007-bl, with every special case."""
        x1, y1, z1 = a
        x2, y2, z2 = b
        if z1 == 0:
            return b
        if z2 == 0:
            return a
        p = cls.p
        z1z1, z2z2 = z1 * z1 % p, z2 * z2 % p
        u1, u2 = x1 * z2z2 % p, x2 * z1z1 % p
        s1, s2 = y1 * z2 * z2z2 % p, y2 * z1 * z1z1 % p
        if u1 == u2:
            return cls.double(a) if s1 == s2 else cls.zero
        h = u2 - u1
        i = 4 * h * h % p
        j = h * i % p
        r = 2 * (s2 - s1) % p
        v = u1 * i % p
        x3 = (r * r - j - 2 * v) % p
        return (x3, (r * (v - x3) - 2 * s1 * j) % p,
                ((z1 + z2) ** 2 - z1z1 - z2z2) * h % p)

    @classmethod
    def normalize(cls, pts) -> list[tuple[int, int]]:
        """Jacobian points, none at infinity -> affine, one inversion."""
        p = cls.p
        zinv = batch_invert([z for _, _, z in pts], p)
        out = []
        for (x, y, _), zi in zip(pts, zinv):
            zi2 = zi * zi % p
            out.append((x * zi2 % p, y * zi2 * zi % p))
        return out

    @classmethod
    def to_affine(cls, a) -> tuple[int, int]:
        """(0, 1) for the point at infinity, as the program writes it."""
        return (0, 1) if a[2] == 0 else cls.normalize([a])[0]
