"""The roofline yardstick: a count worked by hand, the width fixed from n
alone, and no dependence on the engine's window size."""

import numpy as np
import pytest

from msm_bench import work

CONFIG = {"coord_bytes": 48, "scalar_bits": 253, "scalar_bytes": 32,
          "word_products_per_add": 3168}
PEAKS = {"bytes_per_s": 3.35e12, "word_products_per_s": 3.35e13}


def words(scalars):
    raw = b"".join(s.to_bytes(32, "little") for s in scalars)
    return np.frombuffer(raw, dtype=np.uint32).reshape(len(scalars), 8)


def test_count_by_hand():
    # c = 4 (h = 8) over 8-bit scalars: windows of bits 0-3 and 4-7, and a
    # third for the carry (the top window has 4 >= c - 1 bits)
    assert work.num_windows(8, 4) == 3
    # 0x35: digits 5, 3;  0x3d: 13 -> -3 carry 1, 3 + 1 = 4;  0xff: 15 ->
    # -1 carry, 15 + 1 = 16 -> 0 carry, then 1;  0x05: 5, 0
    digits = [list(d) for d in work.signed_digits(words([0x35, 0x3D, 0xFF, 0x05]), 8, 4)]
    assert digits == [[5, -3, -1, 5], [3, 4, 0, 0], [0, 0, 1, 0]]
    # window 0: 4 nonzero digits in buckets {5, 3, 1}: 4 - 3 = 1;
    # window 1: 2 in {3, 4}: 0; window 2: 1 in {1}: 0; each window adds
    # 2 (h - 1) = 14; joining 3 windows (3 - 1) (c + 1) = 10
    assert work.adds(words([0x35, 0x3D, 0xFF, 0x05]), 8, 4) == 1 + 0 + 0 + 3 * 14 + 10


def test_width_from_n_alone():
    assert work.window_width(1 << 20, 253) == 17
    assert work.window_width(1 << 18, 253) == 16
    assert work.model_adds(1 << 20, 253, 17) == 15 * ((1 << 20) + 65534) + 14 * 18


def test_least_seconds_by_hand():
    n, sets, adds = 1 << 10, 4, 10_000
    call_bytes = n * 96 + sets * (n * 32 + 96)
    want = max(call_bytes / sets / 3.35e12, adds * 3168 / 3.35e13)
    assert work.least_seconds(CONFIG, PEAKS, n, sets, adds) == pytest.approx(want, rel=1e-12)


def test_yardstick_ignores_the_engine_window(monkeypatch):
    """The count reads the cell's inputs alone: the engine choosing another
    window size moves nothing."""
    from webgpu_msm_bls12_377_tpu_torch.models import cuzk
    from webgpu_msm_bls12_377_tpu_torch.ops import decompose

    rng = np.random.default_rng(5)
    w = rng.integers(0, 1 << 32, size=(4096, 8), dtype=np.uint32)
    w[:, 7] &= 0x1FFFFFFF
    c = work.window_width(4096, 253)
    before = work.adds(w, 253, c)
    monkeypatch.setattr(decompose, "choose_chunk_size", lambda n: 5)
    monkeypatch.setattr(cuzk, "choose_chunk_size", lambda n: 5)
    assert work.window_width(4096, 253) == c
    assert work.adds(w, 253, c) == before


def test_peaks_for_the_card():
    assert work.peaks_for("NVIDIA H100 80GB HBM3")["bytes_per_s"] == 3.35e12
    assert work.peaks_for("cpu") is None
