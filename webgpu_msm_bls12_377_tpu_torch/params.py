"""BLS12-377 constants and Montgomery parameters for 13 x 32-bit words.

A field element is 13 little-endian 32-bit words, so the Montgomery radix
is R = 2^416.  Twelve words (R = 2^384) would fit p (377 bits), but the
lazy point formulas (ops/curve.py) let values grow to 20p between
reductions and rely on R/p being large: a REDC output is below
p * (1 + bound(a) * bound(b) * p / R), and the formulas' bound products
reach 304.  With R = 2^384, R/p is about 152 and those outputs would no
longer stay below 2p; with R = 2^416, R/p is about 2^39.

The plain PyTorch forms (ops/field.py) compute on 16-bit digits (26 per
value) so that every digit product fits a signed 64-bit lane; the CUDA
kernels (csrc/) use 32-bit words.  REDC's quotient m = -T p^-1 mod R is the
same whichever digit size computes it, so both give identical words.
"""

from __future__ import annotations

import dataclasses
import enum

#: BLS12-377 G1 base field modulus (377 bits).
BLS12_377_BASE_FIELD = int(
    "0x01ae3a4617c510eac63b05c06ca1493b1a22d9f300f5138f1ef3622fba0948001"
    "70b5d44300000008508c00000000001",
    16,
)

#: BLS12-377 scalar field (253 bits): the order of G1's prime subgroup.
SCALAR_FIELD = int(
    "0x12ab655e9a2ca55660b44d1e5c37b00159aa76fed00000010a11800000000001", 16
)

#: BLS12-377 G1 generator.
BLS12_377_G1_GENERATOR_X = int(
    "81937999373150964239938255573465948239988671502647976594219695644855"
    "304257327692006745978603320413799295628339695"
)
BLS12_377_G1_GENERATOR_Y = int(
    "241266749859715473739788878240585681733927191168601896383759122102112"
    "907357779751001206799952863815012735208165030"
)


class CurveId(enum.Enum):
    """Curve selector (the port runs BLS12-377 G1; Edwards comes later)."""

    BLS12_377 = "bls12_377"
    EDWARDS_BLS12 = "edwards_bls12"


NUM_WORDS = 13  # 32-bit words per field element
WORD_BITS = 32
DIGIT_BITS = 16  # digit width of the plain PyTorch Montgomery product
NUM_DIGITS = NUM_WORDS * WORD_BITS // DIGIT_BITS

#: k*p multiples the lazy formulas subtract from (ops/curve.py LAZY_KS).
LAZY_KS = (2, 4, 6, 12, 18)


@dataclasses.dataclass(frozen=True)
class MontParams:
    p: int
    r: int  # R mod p: 1 in Montgomery form
    r2: int  # R^2 mod p: to_mont is one Montgomery product with r2
    rinv: int  # R^-1 mod p
    n0: int  # -p^-1 mod 2^32 (CIOS quotient digit, 32-bit words)
    n0_16: int  # -p^-1 mod 2^16 (plain form, 16-bit digits)

    def to_mont(self, x: int) -> int:
        return x * self.r % self.p

    def from_mont(self, x: int) -> int:
        return x * self.rinv % self.p


def mont_params(p: int) -> MontParams:
    rr = 1 << (NUM_WORDS * WORD_BITS)
    return MontParams(
        p=p,
        r=rr % p,
        r2=rr * rr % p,
        rinv=pow(rr, -1, p),
        n0=-pow(p, -1, 1 << 32) % (1 << 32),
        n0_16=-pow(p, -1, 1 << 16) % (1 << 16),
    )


BLS12_377_PARAMS = mont_params(BLS12_377_BASE_FIELD)


def _words(v: int) -> str:
    return ", ".join(
        f"0x{(v >> (WORD_BITS * i)) & 0xFFFFFFFF:08x}u" for i in range(NUM_WORDS)
    )


def params_header(params: MontParams = BLS12_377_PARAMS) -> str:
    """Text of csrc/params.cuh: the constants every kernel compiles in.

    tests/test_torch_field.py checks the committed header against this."""
    lines = [
        "// Generated from webgpu_msm_bls12_377_tpu_torch/params.py",
        "// (params_header); a test checks that the two agree.",
        "#pragma once",
        "#include <cstdint>",
        "",
        f"#define MSM_NW {NUM_WORDS}",
        f"#define MSM_N0 0x{params.n0:08x}u",
        "",
        f"__constant__ uint32_t MSM_P[MSM_NW] = {{{_words(params.p)}}};",
        f"__constant__ uint32_t MSM_ONE_MONT[MSM_NW] = {{{_words(params.r)}}};",
        "__constant__ uint32_t MSM_THREE_MONT[MSM_NW] = "
        f"{{{_words(3 * params.r % params.p)}}};",
    ]
    for k in LAZY_KS:
        lines.append(
            f"__constant__ uint32_t MSM_KP{k}[MSM_NW] = "
            f"{{{_words(k * params.p)}}};"
        )
    return "\n".join(lines) + "\n"
