"""Plain Python arithmetic of the curves the benchmark runs, for the
fixed bases and the reference: a module a curve, curves/<name>.py with its
`Curve`, found by the configuration's `curve` (adding a curve is adding a
file).  Here: what every curve shares."""

from __future__ import annotations

import importlib


def get(name: str):
    """The curve of that name (curves/<name>.py)."""
    return importlib.import_module(f"{__name__}.{name}").Curve


def batch_invert(values: list[int], p: int) -> list[int]:
    """Inverses mod p of nonzero values: Montgomery's trick, one pow."""
    prefix = [1] * (len(values) + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % p
    inv = pow(prefix[-1], -1, p)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = inv * prefix[i] % p
        inv = inv * values[i] % p
    return out


def mul(curve, k: int, pt: tuple[int, int]):
    """k * pt by double-and-add (k >= 0), in the curve's own coordinates."""
    acc = curve.zero
    base = curve.lift(pt)
    for bit in bin(k)[2:] if k else "":
        acc = curve.double(acc)
        if bit == "1":
            acc = curve.add(acc, base)
    return acc
