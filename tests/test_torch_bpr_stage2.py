"""BPR stage 2 and the window fold of the port (kernel 4's bpr_stage2 and
bpr_fold, csrc/bpr.cu) against the JAX package, for both curves.

On the CPU the wrappers take their plain forms, which follow the kernels'
order of operations: bpr_stage2_plain (b lazy doublings of m, then k's
bits low first, g + temp where a bit is set, temp doubled but after the
top bit) and bpr_fold_plain (the shift-reduce's adds that feed each
window's lane 0).  Here they are held word for word (after from_jax_limbs
and canonicalization) against the JAX package's _bpr_stage2_and_fold on m
and g that JAX made from a numpy seed, its jnp point forms jitted as the
JAX package's own CPU tests run them; a model of the fold kernel's thread
and block mapping reaches each window's lane 0 through the shift-reduce's
pairs; and the stage-2 doublings the kernel leaves out change no word.
The kernels themselves are held against the plain forms on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu.models import cuzk as jcuzk
from webgpu_msm_bls12_377_tpu.ops import bpr as jbpr
from webgpu_msm_bls12_377_tpu_torch.ops import curve as C
from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
from webgpu_msm_bls12_377_tpu_torch.ops.convert import ints_to_words

from test_torch_smvp_bpr import ED, G1

torch.set_num_threads(1)

NPTS = 8
#: the fold kernel's block (csrc/bpr.cu FOLD_THREADS)
FOLD_THREADS = 128


@pytest.fixture(scope="module", params=[G1, ED], ids=["", "ed"])
def curve(request):
    """One curve and the JAX Montgomery table of NPTS oracle points."""
    cv = request.param
    rng = random.Random("bpr-stage2" + cv.group.ctx.tag)
    aff = [cv.point(rng) for _ in range(NPTS)]
    pw = np.stack([ints_to_words([a[0] for a in aff], cv.cw),
                   ints_to_words([a[1] for a in aff], cv.cw)])
    return cv, jcuzk.mont_point_table(cv.jgroup.ctx, cv.jgroup, jnp.asarray(pw))


def lazy_inputs(cv, table, lanes, seed):
    """JAX lazy m and g over `lanes` lanes from a numpy seed: m a lazy
    double of a table point, g m plus another (coordinates above p)."""
    jg = cv.jgroup
    idx = np.random.default_rng(seed).integers(0, NPTS, size=(2, lanes))

    def pts(i):
        return jg.from_affine(tuple(jnp.take(table[c], jnp.asarray(i), axis=1)
                                    for c in range(cv.k)))
    m = jg.double_lazy(pts(idx[0]))
    return m, jg.add_lazy(m, pts(idx[1]))


#: JAX's window sums and the inputs, carried into the port, by (curve,
#: T, bpt), over MAX_WINDOWS windows
_JAX = {}
MAX_WINDOWS = 5


@pytest.mark.parametrize("windows", [1, 3, MAX_WINDOWS])
@pytest.mark.parametrize("bpt", [1, 2, 8])
@pytest.mark.parametrize("t_count", [1, 2, 8, 32])
def test_stage2_and_fold_match_jax(curve, t_count, bpt, windows):
    """Windows are independent lanes of the JAX function, so one JAX call
    over MAX_WINDOWS windows gives the sums of every window count's
    leading windows (one jit compile per T and bpt, not per count)."""
    cv, table = curve
    jg, group = cv.jgroup, cv.group
    key = (group.ctx.tag, t_count, bpt)
    if key not in _JAX:
        m, g = lazy_inputs(cv, table, MAX_WINDOWS * t_count,
                           seed=100 * t_count + bpt)
        want = jax.jit(lambda m, g: jbpr._bpr_stage2_and_fold(
            jg, m, g, MAX_WINDOWS, t_count, bpt))(m, g)
        _JAX[key] = cv.carry(m), cv.carry(g), cv.carry(want)
    pm, pg, want = _JAX[key]
    pm, pg = (x[:, :windows * t_count].contiguous() for x in (pm, pg))
    sums = K.bpr_fold_plain(K.bpr_stage2_plain(pm, pg, t_count, bpt, group),
                            windows, t_count, group)
    got = C.merge(group.canon(group.split(sums)))
    assert got.shape == (group.rows, windows)
    assert torch.equal(got, want[:, :windows])
    # the wrappers take the plain forms for CPU tensors, and count nothing
    K.reset_launches()
    assert torch.equal(K.bpr_fold(K.bpr_stage2(pm, pg, t_count, bpt, group),
                                  windows, t_count, group), sums)
    assert not K.launches


def fold_model(windows, t_count):
    """The fold kernel's schedule over symbolic lanes: per block of
    FOLD_THREADS threads, thread i's lanes and adds as csrc/bpr.cu
    fold_windows runs them (the register levels' pairs in bit-reversed
    order merged on a stack, then the shared-memory levels).  Returns
    {window: expression of its sum}; an expression is a lane index or a
    pair (left, right) of expressions, left the add's first operand."""
    width = min(t_count, FOLD_THREADS)
    per = FOLD_THREADS // width
    pairs = t_count // (2 * FOLD_THREADS)
    bits = pairs.bit_length() - 1
    out = {}
    for block in range(-(-windows // per)):
        sm = [None] * FOLD_THREADS
        for tid in range(FOLD_THREADS):
            li, w = tid % width, block * per + tid // width
            if w >= windows:
                continue
            lane = w * t_count + li
            if pairs == 0:
                sm[tid] = lane
                continue
            stack = []
            for s in range(pairs):
                j = int(format(s, f"0{bits}b")[::-1], 2) if bits else 0
                stack.append((lane + FOLD_THREADS * j,
                              lane + FOLD_THREADS * (j + pairs)))
                c = s + 1
                while not c & 1:
                    top = stack.pop()
                    stack.append((stack.pop(), top))
                    c >>= 1
            assert len(stack) == 1
            sm[tid] = stack[0]
        off = width // 2
        while off >= 1:
            for tid in range(FOLD_THREADS):
                if sm[tid] is not None and tid % width < off:
                    sm[tid] = (sm[tid], sm[tid + off])
            off //= 2
        for tid in range(0, FOLD_THREADS, width):
            w = block * per + tid // width
            if w < windows:
                assert w not in out
                out[w] = sm[tid]
    return out


def shift_reduce(windows, t_count):
    """The JAX package's fold (ops/bpr.py:_bpr_stage2_and_fold): at off =
    T/2, ..., 1 every lane i takes lane i + off (clamped in its window);
    lane 0 of each window holds its sum."""
    vals = list(range(windows * t_count))
    off = t_count // 2
    while off >= 1:
        vals = [(vals[l], vals[(l // t_count) * t_count
                                + min(l % t_count + off, t_count - 1)])
                for l in range(len(vals))]
        off //= 2
    return {w: vals[w * t_count] for w in range(windows)}


@pytest.mark.parametrize("t_count", [1, 2, 8, 64, 128, 256, 512, 1024, 2048])
def test_fold_mapping_takes_the_shift_reduce_pairs(t_count):
    """128 threads a block, T / 128 lanes a thread from T = 256, several
    windows a block below T = 128: every window's sum is the JAX
    shift-reduce's expression, the same pairs in the same operand
    order."""
    windows = 3 if t_count >= 512 else 17
    assert fold_model(windows, t_count) == shift_reduce(windows, t_count)


def stage2_per_lane(m, g, t_count, bpt, group):
    """Stage 2 lane by lane as csrc/bpr.cu stage2_lane runs it: nothing
    where k = 0, else b doublings and k's bits up to its top one (no
    doubling after it)."""
    cols = []
    for lane in range(m.shape[1]):
        k = t_count - 1 - lane % t_count
        acc, temp = g[:, lane:lane + 1], m[:, lane:lane + 1]
        if k:
            for _ in range(bpt.bit_length() - 1):
                temp = K.double_plain(temp, group)
            while True:
                if k & 1:
                    acc = K.add_plain(acc, temp, group)
                k >>= 1
                if not k:
                    break
                temp = K.double_plain(temp, group)
        cols.append(acc)
    return torch.cat(cols, dim=1)


def test_stage2_skipped_doublings_change_no_word(curve):
    """The TPU order doubles temp after every bit, the last included, and
    runs every lane through every bit; the kernel stops each lane at its
    k's top bit and leaves k = 0 lanes as they are.  Both give the same g,
    word for word."""
    cv, table = curve
    group = cv.group
    t_count, bpt, windows = 8, 2, 2
    m, g = (cv.carry(x) for x in lazy_inputs(cv, table, windows * t_count, 7))
    k = t_count - 1 - torch.arange(m.shape[1]) % t_count
    temp = m
    for _ in range(bpt.bit_length() - 1):
        temp = K.double_plain(temp, group)
    tpu = g
    for i in range((t_count - 1).bit_length()):
        added = group.add_lazy(group.split(tpu), group.split(temp))
        tpu = C.merge(group.select(((k >> i) & 1) != 0, added,
                                   group.split(tpu)))
        temp = K.double_plain(temp, group)  # the last one feeds nothing
    got = K.bpr_stage2_plain(m, g, t_count, bpt, group)
    assert torch.equal(got, tpu)
    assert torch.equal(stage2_per_lane(m, g, t_count, bpt, group), tpu)
