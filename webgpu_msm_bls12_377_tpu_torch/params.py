"""Curve constants and Montgomery parameters of the port's two fields.

BLS12-377 G1 (377-bit base field): a field element is 13 little-endian
32-bit words, so the Montgomery radix is R = 2^416.  Twelve words (R = 2^384) would fit p (377 bits), but the
lazy point formulas (ops/curve.py) let values grow to 20p between
reductions and rely on R/p being large: a REDC output is below
p * (1 + bound(a) * bound(b) * p / R), and the formulas' bound products
reach 304.  With R = 2^384, R/p is about 152 and those outputs would no
longer stay below 2p; with R = 2^416, R/p is about 2^39.

The plain PyTorch forms (ops/field.py) compute on 16-bit digits (26 per
value) so that every digit product fits a signed 64-bit lane; the CUDA
kernels (csrc/) use 32-bit words.  REDC's quotient m = -T p^-1 mod R is the
same whichever digit size computes it, so both give identical words.

Twisted Edwards BLS12 (a = -1, d = 3021; its 253-bit base field is the
BLS12-377 scalar field): 9 words, R = 2^288.  Eight words (R = 2^256)
would fit p, but the hwcd lazy formulas (ops/curve.py:EdwardsOps) feed
REDC bound products of 24 (adds) and 48 (the double), and R/p is only
about 13.7 at 8 words, so those outputs would not stay below 2p; at 9
words R/p is about 5.9e10.  Its plain form uses 18 sixteen-bit digits.
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


#: Twisted Edwards BLS12 base field (253 bits) = the BLS12-377 scalar field.
EDWARDS_BLS12_BASE_FIELD = SCALAR_FIELD

#: Twisted Edwards BLS12: a = -1, d = 3021, and its generator.
EDWARDS_D = 3021
EDWARDS_GENERATOR_X = int(
    "1540945439182663264862696551825005342995406165131907382295858612069623286213"
)
EDWARDS_GENERATOR_Y = int(
    "8003546896475222703853313610036801932325312921786952001586936882361378122196"
)
#: Order of Edwards BLS12's prime-order subgroup (the scalar field over the
#: cofactor 4).
EDWARDS_SUBGROUP_CHARACTERISTIC = int(
    "2111115437357092606062206234695386632838870926408408195193685246394721360383"
)


class CurveId(enum.Enum):
    """Curve selector."""

    BLS12_377 = "bls12_377"
    EDWARDS_BLS12 = "edwards_bls12"


NUM_WORDS = 13  # 32-bit words per BLS12-377 field element
ED_NUM_WORDS = 9  # 32-bit words per Edwards BLS12 field element
WORD_BITS = 32
DIGIT_BITS = 16  # digit width of the plain PyTorch Montgomery product

#: k*p multiples the lazy formulas subtract from (ops/curve.py LAZY_KS).
LAZY_KS = (2, 4, 6, 12, 18)
#: the same for the Edwards formulas (ops/curve.py:EdwardsOps)
ED_LAZY_KS = (2, 4)


@dataclasses.dataclass(frozen=True)
class MontParams:
    p: int
    nw: int  # 32-bit words per element: R = 2^(32 nw)
    r: int  # R mod p: 1 in Montgomery form
    r2: int  # R^2 mod p: to_mont is one Montgomery product with r2
    rinv: int  # R^-1 mod p
    n0: int  # -p^-1 mod 2^32 (CIOS quotient digit, 32-bit words)
    n0_16: int  # -p^-1 mod 2^16 (plain form, 16-bit digits)

    def to_mont(self, x: int) -> int:
        return x * self.r % self.p

    def from_mont(self, x: int) -> int:
        return x * self.rinv % self.p


def mont_params(p: int, nw: int) -> MontParams:
    rr = 1 << (nw * WORD_BITS)
    return MontParams(
        p=p,
        nw=nw,
        r=rr % p,
        r2=rr * rr % p,
        rinv=pow(rr, -1, p),
        n0=-pow(p, -1, 1 << 32) % (1 << 32),
        n0_16=-pow(p, -1, 1 << 16) % (1 << 16),
    )


BLS12_377_PARAMS = mont_params(BLS12_377_BASE_FIELD, NUM_WORDS)
EDWARDS_PARAMS = mont_params(EDWARDS_BLS12_BASE_FIELD, ED_NUM_WORDS)


def _words(v: int, nw: int) -> str:
    return ", ".join(
        f"0x{(v >> (WORD_BITS * i)) & 0xFFFFFFFF:08x}u" for i in range(nw)
    )


def _field_lines(params: MontParams, consts: dict[str, int]) -> list[str]:
    lines = [
        f"#define MSM_NW {params.nw}",
        f"#define MSM_N0 0x{params.n0:08x}u",
        "",
        f"__constant__ uint32_t MSM_P[MSM_NW] = {{{_words(params.p, params.nw)}}};",
    ]
    for name, v in consts.items():
        lines.append(
            f"__constant__ uint32_t MSM_{name}[MSM_NW] = "
            f"{{{_words(v, params.nw)}}};"
        )
    return lines


def params_header() -> str:
    """Text of csrc/params.cuh: the constants every kernel compiles in.
    A kernel source built with -DMSM_CURVE_ED gets the Edwards field
    (9 words, the curve's d in Montgomery form, the 2p and 4p columns of
    its lazy formulas), any other the BLS12-377 field.

    tests/test_torch_field.py checks the committed header against this."""
    g1, ed = BLS12_377_PARAMS, EDWARDS_PARAMS
    g1_consts = {"ONE_MONT": g1.r, "THREE_MONT": 3 * g1.r % g1.p}
    g1_consts.update({f"KP{k}": k * g1.p for k in LAZY_KS})
    ed_consts = {"ONE_MONT": ed.r, "D_MONT": EDWARDS_D * ed.r % ed.p}
    ed_consts.update({f"KP{k}": k * ed.p for k in ED_LAZY_KS})
    lines = [
        "// Generated from webgpu_msm_bls12_377_tpu_torch/params.py",
        "// (params_header); a test checks that the two agree.",
        "#pragma once",
        "#include <cstdint>",
        "",
        "#ifdef MSM_CURVE_ED",
        "// Twisted Edwards BLS12 base field: 9 words, R = 2^288",
        *_field_lines(ed, ed_consts),
        "#else",
        "// BLS12-377 base field: 13 words, R = 2^416",
        *_field_lines(g1, g1_consts),
        "#endif",
    ]
    return "\n".join(lines) + "\n"
