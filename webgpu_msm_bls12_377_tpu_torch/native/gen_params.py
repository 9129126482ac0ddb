"""The native oracle's field constants (params_generated.h), derived from
the port's params.py.

6 x 64-bit limbs (R = 2^384) cover both base fields (377 and 253 bits):
for each field its modulus P, R^2 mod p (R2, into Montgomery form), R mod
p (ONE) and N0 = -p^-1 mod 2^64, the BLS_ and ED_ sets; and Edwards' d in
Montgomery form (ED_D_MONT).  The header is written into the oracle's
build directory (native/__init__.py), never beside these sources.
"""

from __future__ import annotations

from pathlib import Path

from ..params import BLS12_377_BASE_FIELD, EDWARDS_BLS12_BASE_FIELD, EDWARDS_D
from ..utils import build_cache

NLIMBS = 6
R = 1 << (64 * NLIMBS)
HEADER = "params_generated.h"


def limbs64(v: int) -> list[int]:
    return [(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(NLIMBS)]


def fmt(name: str, vals: list[int]) -> str:
    body = ", ".join(f"0x{v:016x}ULL" for v in vals)
    return f"static const uint64_t {name}[{len(vals)}] = {{{body}}};"


def field_consts(prefix: str, p: int) -> list[str]:
    n0 = -pow(p, -1, 1 << 64) % (1 << 64)
    return [
        fmt(f"{prefix}_P", limbs64(p)),
        fmt(f"{prefix}_R2", limbs64(R * R % p)),
        fmt(f"{prefix}_ONE", limbs64(R % p)),
        f"static const uint64_t {prefix}_N0 = 0x{n0:016x}ULL;",
    ]


def header() -> str:
    """The header's text."""
    lines = [
        "// Generated by native/gen_params.py from params.py; do not edit.",
        "#pragma once",
        "#include <cstdint>",
        f"static const int NLIMBS = {NLIMBS};",
        *field_consts("BLS", BLS12_377_BASE_FIELD),
        *field_consts("ED", EDWARDS_BLS12_BASE_FIELD),
        fmt("ED_D_MONT", limbs64(EDWARDS_D * R % EDWARDS_BLS12_BASE_FIELD)),
    ]
    return "\n".join(lines) + "\n"


def generate(directory) -> Path:
    """Write the header into `directory` (published with one rename);
    returns its path."""
    path = Path(directory) / HEADER
    tmp = build_cache.staging(path)
    tmp.write_text(header())
    build_cache.publish(tmp, path)
    return path
