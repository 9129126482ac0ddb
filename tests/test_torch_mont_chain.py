"""The carry-chain Montgomery product of csrc/field.cuh (MSM_MONT_CHAIN: the
mont_mul and mont_mul_pair of tree.cu and stream.cu), modelled word by word
on the CPU and held against integer REDC.

The model runs the same steps as the PTX: mont_first, mont_chain,
mont_reduce, mont_shift and mont_merge, each instruction a call on a
carry flag (add.cc, addc.cc, addc, mad.lo.cc, madc.lo.cc, madc.hi.cc,
madc.lo, madc.hi).  It checks what the PTX cannot: an instruction without
.cc never drops a carry (no chain carries out of its top word; only the
last add of mont_merge does, which is the result mod R), every
madc/addc reads a flag that the instruction before it set, and REDC zeroes
x[0].  Both fields (13 and 9 words), for operands at R - 1, at the largest
bound products of ops/curve.py's formulas, with carries at every word, and
hypothesis cases; the plain ops/field.py products are held against the
same REDC on the same operands.  No card is needed; exact integers, no
tolerance.
"""

import random

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from webgpu_msm_bls12_377_tpu_torch.ops import field as F

torch.set_num_threads(1)

M32 = 0xFFFFFFFF


class Flag:
    """The carry flag and the PTX instructions that read or set it."""

    def __init__(self):
        self.cf = None  # None: no instruction has set it

    def _cin(self):
        assert self.cf is not None, "a carry read that nothing set"
        return self.cf

    def _out(self, s, cc, mod_r=False):
        if cc:
            self.cf = s >> 32
        else:
            assert mod_r or s >> 32 == 0, "a carry dropped at the top of a chain"
            self.cf = None
        return s & M32

    def add_cc(self, a, b):
        return self._out(a + b, True)

    def addc(self, a, b, cc, mod_r=False):
        return self._out(a + b + self._cin(), cc, mod_r)

    def mad_lo_cc(self, a, b, c):
        return self._out(((a * b) & M32) + c, True)

    def madc(self, a, b, c, hi, cc):
        half = (a * b) >> 32 if hi else (a * b) & M32
        return self._out(half + c + self._cin(), cc)


def words(v, n):
    return [(v >> (32 * i)) & M32 for i in range(n)]


def value(ws):
    return sum(w << (32 * i) for i, w in enumerate(ws))


def chain(f, acc, q, top, cin, v, y, nw):
    """mont_chain<Q, TOP, CIN, MOD>: v is MSM_P's words or x's."""
    for k in range(top + 1):
        j = (k & ~1) + q
        last = k == top
        if j >= nw:
            acc[k] = f.addc(acc[k], 0, not last)
        elif k & 1:
            acc[k] = f.madc(v[j], y, acc[k], True, not last)
        elif k == 0 and not cin:
            acc[k] = f.mad_lo_cc(v[j], y, acc[k])
        else:
            acc[k] = f.madc(v[j], y, acc[k], False, not last)


def first(q, top, v, y, nw):
    """mont_first<Q, TOP>."""
    out = []
    for k in range(top + 1):
        j = (k & ~1) + q
        out.append(0 if j >= nw else (v[j] * y) >> 32 if k & 1
                   else (v[j] * y) & M32)
    return out


def reduce(f, x, y, ctx):
    nw = ctx.nw
    pw = words(ctx.p, nw)
    m = (x[0] * ctx.params.n0) & M32
    chain(f, x, 0, nw + 1, False, pw, m, nw)
    chain(f, y, 1, nw, False, pw, m, nw)
    assert x[0] == 0


def shift(f, x, y, nw):
    ny = x[2:nw + 2] + [0]
    nx = [f.add_cc(y[0], x[1])] + y[1:nw + 1] + [0]
    return nx, ny


def merge(f, x, y, nw):
    """mont_merge: the result mod R (its one carry that may drop)."""
    r = [f.add_cc(y[0], x[1])]
    r += [f.addc(y[k], x[k + 1], True) for k in range(1, nw - 1)]
    r.append(f.addc(y[nw - 1], x[nw], False, mod_r=True))
    return value(r)


def chain_mont_mul(a, b, ctx):
    nw, f = ctx.nw, Flag()
    aw, bw = words(a, nw), words(b, nw)
    x, y = first(0, nw + 1, aw, bw[0], nw), first(1, nw, aw, bw[0], nw)
    reduce(f, x, y, ctx)
    for i in range(1, nw):
        x, y = shift(f, x, y, nw)
        chain(f, y, 1, nw, True, aw, bw[i], nw)
        chain(f, x, 0, nw + 1, False, aw, bw[i], nw)
        reduce(f, x, y, ctx)
    return merge(f, x, y, nw)


def chain_mont_mul_pair(a, b, c, d, ctx):
    nw, f = ctx.nw, Flag()
    aw, bw, cw, dw = (words(v, nw) for v in (a, b, c, d))
    x, y = first(0, nw + 1, aw, bw[0], nw), first(1, nw, aw, bw[0], nw)
    chain(f, y, 1, nw, False, cw, dw[0], nw)
    chain(f, x, 0, nw + 1, False, cw, dw[0], nw)
    reduce(f, x, y, ctx)
    for i in range(1, nw):
        x, y = shift(f, x, y, nw)
        chain(f, y, 1, nw, True, aw, bw[i], nw)
        chain(f, y, 1, nw, False, cw, dw[i], nw)
        chain(f, x, 0, nw + 1, False, aw, bw[i], nw)
        chain(f, x, 0, nw + 1, False, cw, dw[i], nw)
        reduce(f, x, y, ctx)
    return merge(f, x, y, nw)


def redc(t, ctx):
    """(t + m p) / R mod R, m = -t p^-1 mod R: what both schedules give."""
    r, p = 1 << (32 * ctx.nw), ctx.p
    return (t + (-t * pow(p, -1, r)) % r * p) // r % r


CTXS = pytest.mark.parametrize("ctx", [F.G1_CTX, F.ED_CTX], ids=["", "ed"])


def extreme_operands(ctx):
    """R - 1, values with carries at every word (all-ones words, runs of
    them, one zero word among ones), p - 1, p, 2p - 1, 0 and 1."""
    nw, p = ctx.nw, ctx.p
    r = 1 << (32 * nw)
    out = [r - 1, 0, 1, p - 1, p, 2 * p - 1, r - p]
    out += [(1 << (32 * k)) - 1 for k in range(1, nw)]
    out += [(r - 1) ^ (M32 << (32 * k)) for k in range(nw)]
    out += [value([M32 if (k + s) % 2 else 0 for k in range(nw)])
            for s in (0, 1)]
    return out


#: the largest operands of each formula's Montgomery products and pairs
#: (ops/curve.py, bounds in units of p): G1 double 20*8 and 6*16, full add
#: 8*8; pairs of the mixed add (6*14 + 6*18, 14*14 + 18*6, 14*6 + 6*6),
#: the full add (6*8 + 12*18, 8*8 + 18*6, 8*6 + 6*6) and the affine add
#: (6*4 + 4*6); Edwards double 6*8, add 6*4 and 4*4 (no pairs)
BOUND_PRODUCTS = {
    "": ([(20, 8), (6, 16), (8, 8), (4, 4)],
         [(6, 14, 6, 18), (14, 14, 18, 6), (14, 6, 6, 6), (6, 8, 12, 18),
          (8, 8, 18, 6), (8, 6, 6, 6), (6, 4, 4, 6)]),
    "_ed": ([(6, 8), (6, 4), (4, 4), (2, 2)], []),
}


@CTXS
def test_chain_product_at_extreme_operands(ctx):
    """Every pair of extreme operands, and the pair form with all four at
    them (R - 1 four times: a sum of products near 2R^2)."""
    ops = extreme_operands(ctx)
    for a in ops:
        for b in ops:
            assert chain_mont_mul(a, b, ctx) == redc(a * b, ctx)
    for a, b, c, d in [(o, o, o, o) for o in ops] + [
            (ops[0], ops[3], ops[0], ops[4]), (ops[5], ops[0], ops[0], ops[5])]:
        assert chain_mont_mul_pair(a, b, c, d, ctx) == redc(a * b + c * d, ctx)


@CTXS
def test_chain_product_at_the_formulas_bound_products(ctx):
    """Operands at k*p - 1 for each bound the formulas feed a product or a
    pair: the result is REDC, below 2p."""
    p = ctx.p
    singles, pairs = BOUND_PRODUCTS[ctx.tag]
    for ka, kb in singles:
        a, b = ka * p - 1, kb * p - 1
        got = chain_mont_mul(a, b, ctx)
        assert got == redc(a * b, ctx) and got < 2 * p
    for bounds in pairs:
        a, b, c, d = (k * p - 1 for k in bounds)
        got = chain_mont_mul_pair(a, b, c, d, ctx)
        assert got == redc(a * b + c * d, ctx) and got < 2 * p


@CTXS
def test_plain_products_at_extreme_operands(ctx):
    """ops/field.py's products (the plain forms the kernels are held
    against on the card) give the same REDC mod R on the same operands."""
    ops = extreme_operands(ctx)
    a = [x for x in ops for _ in ops]
    b = [y for _ in ops for y in ops]
    pa, pb = (F.ints_to_plane(v, nw=ctx.nw) for v in (a, b))
    assert F.plane_to_ints(F.mont_mul(pa, pb, ctx)) == [
        redc(x * y, ctx) for x, y in zip(a, b)]
    assert F.plane_to_ints(F.mont_mul_pair(pa, pb, pb, pa, ctx)) == [
        redc(2 * x * y, ctx) for x, y in zip(a, b)]


def test_chain_product_random_lazy_values():
    """Seeded lazy operands below 4p (G1) and 2p (Edwards), as the
    kernels see them."""
    rng = random.Random("mont-chain")
    for ctx, k in ((F.G1_CTX, 4), (F.ED_CTX, 2)):
        for _ in range(40):
            a, b, c, d = (rng.randrange(k * ctx.p) for _ in range(4))
            assert chain_mont_mul(a, b, ctx) == redc(a * b, ctx)
            assert chain_mont_mul_pair(a, b, c, d, ctx) == redc(
                a * b + c * d, ctx)


def below_r(ctx):
    return st.integers(min_value=0, max_value=(1 << (32 * ctx.nw)) - 1)


@CTXS
@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_chain_product_hypothesis(ctx, data):
    a, b, c, d = (data.draw(below_r(ctx)) for _ in range(4))
    assert chain_mont_mul(a, b, ctx) == redc(a * b, ctx)
    assert chain_mont_mul_pair(a, b, c, d, ctx) == redc(a * b + c * d, ctx)
