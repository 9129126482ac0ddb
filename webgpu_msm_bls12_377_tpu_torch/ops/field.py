"""BLS12-377 base-field arithmetic on (13, N) word planes, plain PyTorch.

A field element is 13 little-endian 32-bit words (params.py), stored in a
torch.int32 tensor whose bits are the u32 words; a batch is limb-major,
(13, N).  Every value is an exact integer below 2^416 with a single
representation, so these plain forms and the CUDA kernels (csrc/field.cuh)
agree word for word, lazy (non-canonical) values included.

Lazy values are exact integers below k*p for a bound k that the point
formulas track (ops/curve.py); field_canon reduces them once.  The
Montgomery product works on 16-bit digits in int64 lanes, where every
digit product fits with room for the 26-term column sums.  REDC's quotient
m = -T p^-1 mod 2^416 does not depend on the digit size, so the result
equals the kernels' 32-bit CIOS product exactly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..params import BLS12_377_PARAMS, NUM_WORDS, MontParams

NW = NUM_WORDS
PARAMS: MontParams = BLS12_377_PARAMS
P = PARAMS.p
M32 = 0xFFFFFFFF
M16 = 0xFFFF
ND = 2 * NW  # 16-bit digits per value
#: plain-form lane chunk: bounds the (52, chunk) int64 product scratch
CHUNK = 1 << 18


# ---------------------------------------------------------------------------
# int <-> word-plane converters
# ---------------------------------------------------------------------------


def ints_to_plane(vals: Sequence[int], device=None) -> torch.Tensor:
    """Python ints (each < 2^416) -> (13, N) int32 word plane."""
    buf = b"".join(int(v).to_bytes(4 * NW, "little") for v in vals)
    arr = np.frombuffer(buf, dtype="<u4").reshape(len(vals), NW).T
    return torch.from_numpy(arr.astype(np.uint32).view(np.int32).copy()).to(
        device
    )


def plane_to_ints(plane: torch.Tensor) -> list[int]:
    """(13, N) word plane -> Python ints, one per column."""
    arr = plane.detach().cpu().contiguous().numpy().view(np.uint32)
    raw = np.ascontiguousarray(arr.T).astype("<u4").tobytes()
    step = 4 * arr.shape[0]
    return [
        int.from_bytes(raw[i : i + step], "little")
        for i in range(0, len(raw), step)
    ]


def const_col(v: int, device=None) -> torch.Tensor:
    """A constant as a broadcastable (13, 1) int32 column."""
    return ints_to_plane([v], device)


def _u64(a: torch.Tensor) -> torch.Tensor:
    """int32 word plane -> int64 plane of the u32 word values."""
    return a.to(torch.int64) & M32


def _i32(w: torch.Tensor) -> torch.Tensor:
    """int64 plane of u32 word values -> int32 bit pattern."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def _int_words(v: int, device) -> torch.Tensor:
    return torch.tensor(
        [(v >> (32 * i)) & M32 for i in range(NW)], dtype=torch.int64,
        device=device,
    ).reshape(NW, 1)


def _carry(w: torch.Tensor) -> torch.Tensor:
    """Normalize an int64 word plane (entries may be negative or exceed
    32 bits) to u32 words of the same value mod 2^416."""
    out = []
    c = None
    for i in range(w.shape[0]):
        s = w[i] if c is None else w[i] + c
        out.append(s & M32)
        c = s >> 32  # arithmetic: a borrow carries as -1
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Lazy (exact, unreduced) add/sub.  Same names and k choices as the JAX
# package's ops/field.py, so the bound comments in ops/curve.py hold.
# ---------------------------------------------------------------------------


def lazy_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b: bound(out) = bound(a) + bound(b)."""
    return _i32(_carry(_u64(a) + _u64(b)))


def lazy_triple(a: torch.Tensor) -> torch.Tensor:
    """3a: bound(out) = 3 bound(a)."""
    return lazy_scale(a, 3)


def lazy_scale(a: torch.Tensor, c: int) -> torch.Tensor:
    """c*a for a small constant c: bound(out) = c bound(a)."""
    return _i32(_carry(_u64(a) * c))


def lazy_sub(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """a + k*p - b, exact for b <= a + k*p: bound(out) = bound(a) + k."""
    kp = _int_words(k * P, a.device)
    return _i32(_carry(_u64(a) + kp - _u64(b)))


def lazy_neg(b: torch.Tensor, k: int) -> torch.Tensor:
    """k*p - b, exact for b <= k*p: bound(out) = k."""
    kp = _int_words(k * P, b.device)
    return _i32(_carry(kp - _u64(b)))


def _cond_sub(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """s - c where s >= c, else s (u32 int64 word planes, c broadcast)."""
    out = []
    borrow = 0
    for i in range(s.shape[0]):
        t = s[i] - c[i] + borrow
        out.append(t & M32)
        borrow = t >> 32  # 0, or -1 on a borrow
    return torch.where((borrow == 0)[None], torch.stack(out), s)


def field_canon(s: torch.Tensor, bound: int = 4) -> torch.Tensor:
    """Lazy value < bound*p -> canonical residue < p.

    ceil(log2(bound)) - 1 conditional subtracts of halving multiples of p,
    then one of p (the JAX package's field_canon)."""
    w = _u64(s)
    k = 1
    while k < bound:
        k *= 2
    while k > 2:
        k //= 2
        w = _cond_sub(w, _int_words(k * P, s.device))
    w = _cond_sub(w, _int_words(P, s.device))
    return _i32(w)


def field_neg(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p for canonical a, with 0 -> 0."""
    w = _u64(a)
    zero = (w == 0).all(dim=0, keepdim=True)
    neg = _carry(_int_words(P, a.device) - w)
    return _i32(torch.where(zero, w, neg))


def field_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for canonical a, b: one conditional subtract of p."""
    return _i32(_cond_sub(_carry(_u64(a) + _u64(b)), _int_words(P, a.device)))


def field_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for canonical a, b: a + p - b, then one conditional
    subtract of p."""
    pw = _int_words(P, a.device)
    return _i32(_cond_sub(_carry(_u64(a) + pw - _u64(b)), pw))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(N,) mask of the all-zero columns of a (13, N) plane."""
    return (a == 0).all(dim=0)


# ---------------------------------------------------------------------------
# Montgomery products (R = 2^416), 16-bit digits
# ---------------------------------------------------------------------------


def _digits(w: torch.Tensor) -> torch.Tensor:
    """(13, ...) u32 int64 words -> (26, ...) 16-bit digits."""
    return torch.stack([w & M16, w >> 16], dim=1).reshape(ND, *w.shape[1:])


def _p_digits(device) -> torch.Tensor:
    return torch.tensor(
        [(P >> (16 * i)) & M16 for i in range(ND)], dtype=torch.int64,
        device=device,
    ).reshape(ND, 1)


def _redc(t: torch.Tensor) -> torch.Tensor:
    """(52, n) int64 digit columns of T -> REDC(T) = (T + m p) / 2^416 as
    (13, n) u32 int64 words, mod 2^416."""
    pd = _p_digits(t.device)
    n0 = PARAMS.n0_16
    for i in range(ND):
        q = ((t[i] & M16) * n0) & M16
        t[i : i + ND] += q[None] * pd
        t[i + 1] += t[i] >> 16
    hi = t[ND:]
    out = []
    c = None
    for i in range(ND):
        s = hi[i] if c is None else hi[i] + c
        out.append(s & M16)
        c = s >> 16
    d = torch.stack(out)
    return d[0::2] | (d[1::2] << 16)


def _lanes(*xs: torch.Tensor) -> int:
    return max(x.shape[-1] for x in xs)


def _mont(pairs, n: int, device) -> torch.Tensor:
    """REDC(sum of x*y over pairs) on (13, n) int32 planes, chunked."""
    outs = []
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        t = torch.zeros((2 * ND, hi - lo), dtype=torch.int64, device=device)
        for x, y in pairs:
            xd = _digits(_u64(x[:, lo:hi] if x.shape[-1] > 1 else x))
            yd = _digits(_u64(y[:, lo:hi] if y.shape[-1] > 1 else y))
            for i in range(ND):
                t[i : i + ND] += xd[i][None] * yd
        outs.append(_redc(t))
    return _i32(torch.cat(outs, dim=1))


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """REDC(a*b) for exact inputs < 2^416; output < a*b/2^416 + p."""
    return _mont([(a, b)], _lanes(a, b), a.device)


def mont_mul_pair(a, b, c, d) -> torch.Tensor:
    """REDC(a*b + c*d): one reduction for a sum of two products."""
    return _mont([(a, b), (c, d)], _lanes(a, b, c, d), a.device)


def mont_mul_canon(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """REDC(a*b) mod p for canonical a, b (REDC(a*b) < 2p): the product of
    the canonical-domain point formulas."""
    return field_canon(mont_mul(a, b), 2)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """x -> x R mod p, canonical (REDC(x R^2) < 2p for any x < 2^416)."""
    return field_canon(mont_mul(a, const_col(PARAMS.r2, a.device)), 2)


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """x R -> x mod p, canonical."""
    return field_canon(mont_mul(a, const_col(1, a.device)), 2)
