"""The fixed bases and the reference against sums worked by hand with
double-and-add, on both curves."""

import numpy as np
import pytest

from msm_bench import bases as B
from msm_bench import curves, reference
from msm_bench.control import Caller as Control

CURVES = ["bls12_377", "edwards_bls12"]


@pytest.fixture(scope="module", params=CURVES)
def small(request):
    return B.make(curves.get(request.param), 8, workers=1)


def hand_msm(curve, points, scalars):
    acc = curve.zero
    for pt, s in zip(points, scalars):
        acc = curve.add(acc, curves.mul(curve, s, pt))
    return curve.to_affine(acc)


def to_words(scalars):
    raw = b"".join(s.to_bytes(32, "little") for s in scalars)
    return np.frombuffer(raw, dtype=np.uint32).reshape(len(scalars), 8).copy()


def test_bases_are_their_logs_times_g(small):
    c = small.curve
    assert reference.check_bases(small, range(small.n)) == []
    for i in range(small.n):
        assert c.on_curve(small.point(i))
    assert len({small.point(i) for i in range(small.n)}) == small.n


@pytest.mark.parametrize("scalars", [
    [1, 0, 0, 0, 0, 0, 0, 0],
    [3, 5, 0, 1, 2, 0, 7, 1],
    [(1 << 253) - 1, (1 << 252) + 12345, 2, 0, 1 << 200, 9, 1, 4],
])
def test_reference_equals_the_hand_sum(small, scalars):
    pts = [small.point(i) for i in range(small.n)]
    want = hand_msm(small.curve, pts, scalars)
    assert reference.msm(small, to_words(scalars)) == want


def test_identity_is_0_1(small):
    order = small.curve.order
    # s_0 k_0 + s_1 k_1 = 0 mod order
    k0, k1 = small.log(0), small.log(1)
    s0, s1 = k1, order - k0
    scalars = [s0, s1] + [0] * 6
    assert reference.msm(small, to_words(scalars)) == (0, 1)


def test_a_wrong_base_is_caught(small):
    bad = B.Bases(small.curve, small.wire.copy(), small.idx, small.cs, small.es)
    bad.wire[3] = small.wire[4]
    assert reference.check_bases(bad, range(small.n)) == [3]


def test_control_drops_bit_252(small):
    scalars = [(1 << 252) + 5, 7, 0, 0, 0, 0, 0, 0]
    words = to_words(scalars)
    control = Control(small, [words])
    got = control.call([0])[0]
    assert got == reference.msm(small, to_words([5, 7] + [0] * 6))
    assert got != reference.msm(small, words)
