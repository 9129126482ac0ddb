"""Base-field arithmetic on word planes, plain PyTorch, for either field.

A field element is nw little-endian 32-bit words (params.py: 13 for
BLS12-377, 9 for Twisted Edwards BLS12), stored in a torch.int32 tensor
whose bits are the u32 words; a batch is limb-major, (nw, N).  Every value
is an exact integer below R = 2^(32 nw) with a single representation, so
these plain forms and the CUDA kernels (csrc/field.cuh) agree word for
word, lazy (non-canonical) values included.

A FieldCtx names the field (the counterpart of the JAX package's
FieldCtx / field_ctx): every operation that depends on p takes one, and
defaults to BLS12-377's.  Lazy values are exact integers below k*p for a
bound k that the point formulas track (ops/curve.py); field_canon reduces
them once.  The Montgomery product works on 16-bit digits in int64 lanes,
where every digit product fits with room for the column sums.  REDC's
quotient m = -T p^-1 mod R does not depend on the digit size, so the
result equals the kernels' 32-bit CIOS product exactly.
"""

from __future__ import annotations

import dataclasses
import functools

from typing import Sequence

import numpy as np
import torch

from ..params import (
    BLS12_377_PARAMS,
    EDWARDS_PARAMS,
    NUM_WORDS,
    CurveId,
    MontParams,
)

NW = NUM_WORDS
PARAMS: MontParams = BLS12_377_PARAMS
P = PARAMS.p
M32 = 0xFFFFFFFF
M16 = 0xFFFF
#: plain-form lane chunk: bounds the (2 nd, chunk) int64 product scratch
CHUNK = 1 << 18


@dataclasses.dataclass(frozen=True)
class FieldCtx:
    """One field: its Montgomery parameters, and the suffix of the kernel
    libraries built for it (ops/kernels.py)."""

    params: MontParams
    tag: str

    @property
    def p(self) -> int:
        return self.params.p

    @property
    def nw(self) -> int:
        return self.params.nw

    @property
    def nd(self) -> int:
        return 2 * self.params.nw

    def kp(self, k: int, device) -> torch.Tensor:
        """(nw, 1) int64 words of k*p (cached and read-only)."""
        return _int_words(k * self.params.p, self.params.nw, device)

    def col(self, v: int, device=None) -> torch.Tensor:
        """A constant as a (nw, 1) int32 column (const_col)."""
        return const_col(v, device, self.params.nw)


G1_CTX = FieldCtx(BLS12_377_PARAMS, "")
ED_CTX = FieldCtx(EDWARDS_PARAMS, "_ed")


def field_ctx(curve: CurveId) -> FieldCtx:
    return G1_CTX if curve == CurveId.BLS12_377 else ED_CTX


# ---------------------------------------------------------------------------
# int <-> word-plane converters
# ---------------------------------------------------------------------------


def ints_to_plane(vals: Sequence[int], device=None, nw: int = NW) -> torch.Tensor:
    """Python ints (each < 2^(32 nw)) -> (nw, N) int32 word plane."""
    buf = b"".join(int(v).to_bytes(4 * nw, "little") for v in vals)
    arr = np.frombuffer(buf, dtype="<u4").reshape(len(vals), nw).T
    return torch.from_numpy(arr.astype(np.uint32).view(np.int32).copy()).to(
        device
    )


def plane_to_ints(plane: torch.Tensor) -> list[int]:
    """(nw, N) word plane -> Python ints, one per column."""
    arr = plane.detach().cpu().contiguous().numpy().view(np.uint32)
    raw = np.ascontiguousarray(arr.T).astype("<u4").tobytes()
    step = 4 * arr.shape[0]
    return [
        int.from_bytes(raw[i : i + step], "little")
        for i in range(0, len(raw), step)
    ]


@functools.lru_cache(maxsize=None)
def const_col(v: int, device=None, nw: int = NW) -> torch.Tensor:
    """A constant as a broadcastable (nw, 1) int32 column.  Cached by
    device and read-only: copying a host constant to a CUDA device makes
    the host wait for the stream, so each crosses once."""
    return ints_to_plane([v], device, nw)


def _u64(a: torch.Tensor) -> torch.Tensor:
    """int32 word plane -> int64 plane of the u32 word values."""
    return a.to(torch.int64) & M32


def _i32(w: torch.Tensor) -> torch.Tensor:
    """int64 plane of u32 word values -> int32 bit pattern."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _int_words(v: int, nw: int, device) -> torch.Tensor:
    """(nw, 1) int64 words of a constant; cached and read-only, as
    const_col."""
    return torch.tensor(
        [(v >> (32 * i)) & M32 for i in range(nw)], dtype=torch.int64,
        device=device,
    ).reshape(nw, 1)


def _carry(w: torch.Tensor) -> torch.Tensor:
    """Normalize an int64 word plane (entries may be negative or exceed
    32 bits) to u32 words of the same value mod 2^(32 rows)."""
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


def lazy_sub(a: torch.Tensor, b: torch.Tensor, k: int,
             ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """a + k*p - b, exact for b <= a + k*p: bound(out) = bound(a) + k."""
    return _i32(_carry(_u64(a) + ctx.kp(k, a.device) - _u64(b)))


def lazy_neg(b: torch.Tensor, k: int, ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """k*p - b, exact for b <= k*p: bound(out) = k."""
    return _i32(_carry(ctx.kp(k, b.device) - _u64(b)))


def _cond_sub(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """s - c where s >= c, else s (u32 int64 word planes, c broadcast)."""
    out = []
    borrow = 0
    for i in range(s.shape[0]):
        t = s[i] - c[i] + borrow
        out.append(t & M32)
        borrow = t >> 32  # 0, or -1 on a borrow
    return torch.where((borrow == 0)[None], torch.stack(out), s)


def field_canon(s: torch.Tensor, bound: int = 4,
                ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """Lazy value < bound*p -> canonical residue < p.

    ceil(log2(bound)) - 1 conditional subtracts of halving multiples of p,
    then one of p (the JAX package's field_canon)."""
    w = _u64(s)
    k = 1
    while k < bound:
        k *= 2
    while k > 2:
        k //= 2
        w = _cond_sub(w, ctx.kp(k, s.device))
    w = _cond_sub(w, ctx.kp(1, s.device))
    return _i32(w)


def field_neg(a: torch.Tensor, ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """(-a) mod p for canonical a, with 0 -> 0."""
    w = _u64(a)
    zero = (w == 0).all(dim=0, keepdim=True)
    neg = _carry(ctx.kp(1, a.device) - w)
    return _i32(torch.where(zero, w, neg))


def field_add(a: torch.Tensor, b: torch.Tensor,
              ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """(a + b) mod p for canonical a, b: one conditional subtract of p."""
    return _i32(_cond_sub(_carry(_u64(a) + _u64(b)), ctx.kp(1, a.device)))


def field_sub(a: torch.Tensor, b: torch.Tensor,
              ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """(a - b) mod p for canonical a, b: a + p - b, then one conditional
    subtract of p."""
    pw = ctx.kp(1, a.device)
    return _i32(_cond_sub(_carry(_u64(a) + pw - _u64(b)), pw))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(N,) mask of the all-zero columns of a (nw, N) plane."""
    return (a == 0).all(dim=0)


# ---------------------------------------------------------------------------
# Montgomery products (R = 2^(32 nw)), 16-bit digits
# ---------------------------------------------------------------------------


def _digits(w: torch.Tensor) -> torch.Tensor:
    """(nw, ...) u32 int64 words -> (2 nw, ...) 16-bit digits."""
    return torch.stack([w & M16, w >> 16], dim=1).reshape(
        2 * w.shape[0], *w.shape[1:])


@functools.lru_cache(maxsize=None)
def _p_digits(p: int, nd: int, device) -> torch.Tensor:
    """(nd, 1) 16-bit digits of p; cached and read-only, as const_col."""
    return torch.tensor(
        [(p >> (16 * i)) & M16 for i in range(nd)], dtype=torch.int64,
        device=device,
    ).reshape(nd, 1)


def _redc(t: torch.Tensor, ctx: FieldCtx) -> torch.Tensor:
    """(2 nd, n) int64 digit columns of T -> REDC(T) = (T + m p) / R as
    (nw, n) u32 int64 words, mod R."""
    nd = ctx.nd
    pd = _p_digits(ctx.p, nd, t.device)
    n0 = ctx.params.n0_16
    for i in range(nd):
        q = ((t[i] & M16) * n0) & M16
        t[i : i + nd] += q[None] * pd
        t[i + 1] += t[i] >> 16
    hi = t[nd:]
    out = []
    c = None
    for i in range(nd):
        s = hi[i] if c is None else hi[i] + c
        out.append(s & M16)
        c = s >> 16
    d = torch.stack(out)
    return d[0::2] | (d[1::2] << 16)


def _lanes(*xs: torch.Tensor) -> int:
    return max(x.shape[-1] for x in xs)


def _mont(pairs, n: int, device, ctx: FieldCtx) -> torch.Tensor:
    """REDC(sum of x*y over pairs) on (nw, n) int32 planes, chunked."""
    nd = ctx.nd
    for x, y in pairs:
        if x.shape[0] != ctx.nw or y.shape[0] != ctx.nw:
            raise ValueError(f"operands of {x.shape[0]} and {y.shape[0]} "
                             f"words in a {ctx.nw}-word field")
    outs = []
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        t = torch.zeros((2 * nd, hi - lo), dtype=torch.int64, device=device)
        for x, y in pairs:
            xd = _digits(_u64(x[:, lo:hi] if x.shape[-1] > 1 else x))
            yd = _digits(_u64(y[:, lo:hi] if y.shape[-1] > 1 else y))
            for i in range(nd):
                t[i : i + nd] += xd[i][None] * yd
        outs.append(_redc(t, ctx))
    return _i32(torch.cat(outs, dim=1))


def mont_mul(a: torch.Tensor, b: torch.Tensor,
             ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """REDC(a*b) for exact inputs < R; output < a*b/R + p."""
    return _mont([(a, b)], _lanes(a, b), a.device, ctx)


def mont_mul_pair(a, b, c, d, ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """REDC(a*b + c*d): one reduction for a sum of two products."""
    return _mont([(a, b), (c, d)], _lanes(a, b, c, d), a.device, ctx)


def mont_mul_canon(a: torch.Tensor, b: torch.Tensor,
                   ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """REDC(a*b) mod p for canonical a, b (REDC(a*b) < 2p): the product of
    the canonical-domain point formulas."""
    return field_canon(mont_mul(a, b, ctx), 2, ctx)


def to_mont(a: torch.Tensor, ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """x -> x R mod p, canonical (REDC(x R^2) < 2p for any x < R)."""
    return mont_mul_canon(a, ctx.col(ctx.params.r2, a.device), ctx)


def from_mont(a: torch.Tensor, ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """x R -> x mod p, canonical."""
    return mont_mul_canon(a, ctx.col(1, a.device), ctx)
