"""harness/autotune.py of the port and the engine's autotune keyword, on
the CPU: the JAX package's three autotune tests (tests/test_autotune.py)
with injected measurements; parity with the JAX package (the same fake
timings give the same winners and entries; tuned entries resolve to the
same window size, path and K in both engines, a stale one included); a
real tuning run at n = 2^8; a wrong result stops a run, any other failure
disqualifies its candidate alone.  Every test points MSM_AUTOTUNE_DIR at
its own temporary directory.  The card's run (cuda-marked) tunes 2^16 with
the real measurement and skips here."""

import gc
import json
import random

import numpy as np
import pytest
import torch

from webgpu_msm_bls12_377_tpu_torch.harness import autotune
from webgpu_msm_bls12_377_tpu_torch.harness import testdata as TD
from webgpu_msm_bls12_377_tpu_torch.models.cuzk import CuzkMsmEngine
from webgpu_msm_bls12_377_tpu_torch.ops.convert import ints_to_words
from webgpu_msm_bls12_377_tpu_torch.params import CurveId
from webgpu_msm_bls12_377_tpu_torch.reference import curve as crv

torch.set_num_threads(1)

G1, ED = CurveId.BLS12_377, CurveId.EDWARDS_BLS12


@pytest.fixture(autouse=True)
def table_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MSM_AUTOTUNE_DIR", str(tmp_path))
    return tmp_path


@pytest.fixture
def no_gc(monkeypatch):
    """Fake measurements hold no memory: both packages' gc.collect after
    each candidate (0.2 s each with JAX and PyTorch loaded) is skipped."""
    monkeypatch.setattr(gc, "collect", lambda *a: 0)


def engine(curve=G1, **kw):
    return CuzkMsmEngine(curve, device="cpu", **kw)


def read_table(d):
    with open(d / ".autotune_torch.json") as f:
        return json.load(f)


def test_autotune_selects_persists_and_engine_consults(table_dir, no_gc):
    fake = {13: 0.30, 15: 0.20, 16: 0.25}

    def measure(engine_cls, curve, n, chunk, runs):
        assert engine_cls is CuzkMsmEngine and runs == 2
        return fake[chunk]

    w = autotune.autotune_chunk(G1, 1 << 16, measure_fn=measure, device="cpu")
    assert w == 15

    # persisted, keyed by device/curve/n, with the timings recorded
    table = read_table(table_dir)
    assert list(table) == ["cpu/cpu"]
    entry = table["cpu/cpu"]["BLS12_377"]["65536"]
    assert entry["chunk"] == 15
    assert entry["warm_s"]["13"] == 0.30

    # lookup: tuned size hits, untuned size misses
    assert autotune.lookup(G1, 1 << 16, device="cpu") == 15
    assert autotune.lookup(G1, 1 << 18, device="cpu") is None
    assert autotune.lookup(ED, 1 << 16, device="cpu") is None

    # the engine consults the table only with autotune on, and the
    # explicit override still wins
    eng = engine(autotune=True)
    assert eng._chunk_for(1 << 16) == 15
    assert eng._chunk_for(1 << 18) == 15  # static policy fallback
    assert eng._chunk_for(1 << 20) == 16
    assert engine(autotune=False)._chunk_for(1 << 16) == 15  # static policy
    fake2 = {**fake, 13: 0.01}

    def measure2(engine_cls, curve, n, chunk, runs):
        return fake2[chunk]

    assert autotune.autotune_chunk(G1, 1 << 16, measure_fn=measure2,
                                   device="cpu") == 13
    assert engine(autotune=True)._chunk_for(1 << 16) == 13
    assert engine(autotune=True, chunk_size=16)._chunk_for(1 << 16) == 16


def test_autotune_default_on_and_disable(no_gc):
    """autotune is the default: an engine with no flags consults the
    table; autotune=False restores the static policy."""
    autotune.autotune_chunk(
        G1, 1 << 18, device="cpu",
        measure_fn=lambda *_a: {13: 0.1, 15: 0.3, 16: 0.3}[_a[3]],
    )
    assert engine()._chunk_for(1 << 18) == 13
    assert engine(autotune=False)._chunk_for(1 << 18) == 15


def test_autotune_smvp_selects_persists_and_engine_consults(no_gc):
    fake = {
        ("stream", None): 0.25,
        ("tree", 1): 0.30,
        ("tree", 2): 0.28,
        ("tree", 3): 0.31,
    }

    def measure(curve, n, chunk, smvp, k, runs):
        assert chunk == 16  # the 2^20 static policy feeds the candidates
        return fake[(smvp, k)]

    m, k = autotune.autotune_smvp(G1, 1 << 20, measure_fn=measure,
                                  device="cpu")
    assert (m, k) == ("stream", None)
    entry = autotune.lookup_entry(G1, 1 << 20, device="cpu")
    assert entry["smvp"] == "stream" and entry["tree_finish"] is None
    assert entry["smvp_warm_s"]["tree-K2"] == 0.28
    # a tuned "stream" overrides the static tree boundary; K stays 2
    eng = engine()
    assert eng._select_smvp(16, 1 << 20) == "stream"
    assert eng._tree_k(1 << 20) == 2
    assert engine(autotune=False)._select_smvp(16, 1 << 20) == "tree"

    fake2 = dict(fake)
    fake2[("tree", 3)] = 0.01
    m2, k2 = autotune.autotune_smvp(
        G1, 1 << 20, device="cpu", measure_fn=lambda *a: fake2[(a[3], a[4])]
    )
    assert (m2, k2) == ("tree", 3)
    eng = engine()
    assert eng._select_smvp(16, 1 << 20) == "tree"
    assert eng._tree_k(1 << 20) == 3
    assert eng._tree_k(1 << 20, batch=True) == 3  # a batch takes it too
    assert eng._tree_k(1 << 18) == 2  # untuned n: the measured default
    assert eng._tree_k() == 2
    # explicit tree_finish still wins over the table; an explicit "tree"
    # without it stays the pure tree (a batch: the hybrid's 2)
    assert engine(tree_finish=1)._tree_k(1 << 20) == 1
    assert engine(smvp_mode="tree")._tree_k(1 << 20) is None
    assert engine(smvp_mode="tree")._tree_k(1 << 20, batch=True) == 2
    # autotune=False ignores the table entirely
    assert engine(autotune=False)._tree_k(1 << 20) == 2


@pytest.fixture
def jax_pkg(monkeypatch):
    """The JAX package's autotune module, engine module and CurveId, its
    backend probes answering as on a TPU (its tree and stream paths need
    one), as test_torch_fused_batch.py does.  Imported here, so that the
    card's run (no JAX there) collects this file."""
    from webgpu_msm_bls12_377_tpu.harness import autotune as jautotune
    from webgpu_msm_bls12_377_tpu.models import cuzk as jcuzk
    from webgpu_msm_bls12_377_tpu.ops import smvp_kernel as jfused
    from webgpu_msm_bls12_377_tpu.ops import smvp_stream as jstream
    from webgpu_msm_bls12_377_tpu.ops import smvp_tree as jtree
    from webgpu_msm_bls12_377_tpu.params import CurveId as JCurveId

    for mod in (jstream, jtree, jfused):
        monkeypatch.setattr(mod, "_on_tpu", lambda: True)
    return jautotune, jcuzk, JCurveId


def test_same_fake_timings_same_winners_and_entries(table_dir, jax_pkg,
                                                  no_gc):
    """The same fake timings through both packages' autotune_chunk and
    autotune_smvp give the same winners and the same table entries, up to
    the device key and the file name."""
    jautotune, _, JCurveId = jax_pkg
    chunk_t = {13: 0.31, 15: 0.12, 16: 0.2}
    smvp_t = {("stream", None): 0.3, ("tree", 1): 0.2, ("tree", 2): 0.1,
              ("tree", 3): 0.4}
    for power in (16, 20):
        for pc, jc in ((G1, JCurveId.BLS12_377),
                       (ED, JCurveId.EDWARDS_BLS12)):
            n = 1 << power
            assert (autotune.autotune_chunk(
                pc, n, device="cpu", measure_fn=lambda *a: chunk_t[a[3]])
                == jautotune.autotune_chunk(
                    jc, n, measure_fn=lambda *a: chunk_t[a[3]]))
            assert (autotune.autotune_smvp(
                pc, n, device="cpu",
                measure_fn=lambda *a: smvp_t[(a[3], a[4])])
                == jautotune.autotune_smvp(
                    jc, n, measure_fn=lambda *a: smvp_t[(a[3], a[4])]))
    with open(table_dir / ".autotune.json") as f:
        jtable = json.load(f)
    ptable = read_table(table_dir)
    (jentries,), (pentries,) = jtable.values(), ptable.values()
    assert list(ptable) == ["cpu/cpu"] and pentries == jentries
    assert pentries["BLS12_377"]["1048576"]["smvp_warm_s"]["tree-K2"] == 0.1


#: tuned entries for the resolution parity: (curve name, n, entry); the
#: 2^14 one is stale (chunk 4 has no whole 256-lane slabs: its "tree" is
#: passed over for the static policy)
ENTRIES = (
    ("BLS12_377", 1 << 14, {"chunk": 4, "smvp": "tree", "tree_finish": 3}),
    ("BLS12_377", 1 << 16, {"chunk": 13, "smvp": "tree", "tree_finish": 3}),
    ("BLS12_377", 1 << 18, {"smvp": "tree", "tree_finish": 1}),
    ("BLS12_377", 1 << 20, {"chunk": 15, "smvp": "stream",
                            "tree_finish": None}),
    ("EDWARDS_BLS12", 1 << 17, {"chunk": 16, "smvp": "tree",
                                "tree_finish": 2}),
    ("EDWARDS_BLS12", 1 << 19, {"chunk": 13}),
)


@pytest.mark.parametrize("curve", ["bls12_377", "edwards_bls12"],
                         ids=["", "ed"])
def test_tuned_entries_resolve_as_in_the_jax_engine(curve, jax_pkg):
    """Entries written under each package's own key: the port's
    _chunk_for, _select_smvp (at the resolved chunk and at every chunk 4 to
    16) and _tree_k equal the JAX engine's at every n = 2^6 .. 2^20."""
    jautotune, jcuzk, JCurveId = jax_pkg
    jtable, ptable = {}, {}
    for name, n, entry in ENTRIES:
        for table, key in ((jtable, jautotune._device_key()),
                           (ptable, "cpu/cpu")):
            table.setdefault(key, {}).setdefault(name, {})[str(n)] = entry
    jautotune.save_table(jtable)
    autotune.save_table(ptable)
    jeng = jcuzk.CuzkMsmEngine(JCurveId(curve))
    eng = engine(CurveId(curve))
    assert eng.autotune and jeng.autotune
    for power in range(6, 21):
        n = 1 << power
        chunk = eng._chunk_for(n)
        assert chunk == jeng._chunk_for(n), power
        for c in {chunk, *range(4, 17)}:
            assert eng._select_smvp(c, n) == jeng._select_smvp(c, n), (c, n)
        assert eng._tree_k(n) == jeng._tree_k(n), power
    if curve == "bls12_377":
        # the stale entry: chunk 4 from the table, the static fused path
        assert eng._chunk_for(1 << 14) == 4
        assert eng._select_smvp(4, 1 << 14) == "fused"
        assert eng._select_smvp(13, 1 << 16) == "tree"
        assert eng._select_smvp(15, 1 << 20) == "stream"


def test_the_jax_table_does_not_steer_the_port(jax_pkg, no_gc):
    """A JAX run on the CPU writes "cpu/cpu" entries to its own file; the
    port reads only .autotune_torch.json."""
    jautotune, _, JCurveId = jax_pkg
    jautotune.autotune_chunk(JCurveId.BLS12_377, 1 << 16,
                             measure_fn=lambda *a: {13: 0.1, 15: 0.2,
                                                    16: 0.3}[a[3]])
    assert jautotune.lookup(JCurveId.BLS12_377, 1 << 16) == 13
    assert autotune.load_table() == {}
    assert engine()._chunk_for(1 << 16) == 15


def test_a_failing_candidate_is_disqualified_alone(table_dir, capsys, no_gc):
    def measure(engine_cls, curve, n, chunk, runs):
        if chunk == 16:
            raise RuntimeError("out of memory")
        return {13: 0.2, 15: 0.1}[chunk]

    assert autotune.autotune_chunk(G1, 1 << 20, measure_fn=measure,
                                   device="cpu") == 15
    assert "chunk 16: disqualified (RuntimeError" in capsys.readouterr().out
    entry = read_table(table_dir)["cpu/cpu"]["BLS12_377"]["1048576"]
    assert entry == {"chunk": 15, "warm_s": {"13": 0.2, "15": 0.1}}

    def smvp_measure(curve, n, chunk, smvp, k, runs):
        if k == 1:
            raise RuntimeError("launch failed")
        return {None: 0.3, 2: 0.2, 3: 0.25}[k]

    assert autotune.autotune_smvp(G1, 1 << 20, measure_fn=smvp_measure,
                                  device="cpu") == ("tree", 2)
    assert "tree-K1" not in autotune.lookup_entry(
        G1, 1 << 20, device="cpu")["smvp_warm_s"]
    with pytest.raises(ValueError, match="no viable chunk"):
        autotune.autotune_chunk(G1, 1 << 20, device="cpu",
                                measure_fn=lambda *a: 1 / 0)


def write_bench_cases(d, powers) -> str:
    """Edwards bench cases at `powers` in directory d under their .npz
    names, by the seed scheme with Python integers (as
    tests/test_torch_bench.py)."""
    for power in powers:
        rng = random.Random(f"bench-{power}-edwards_bls12")
        n = 1 << power
        ks = [rng.randrange(1, TD.curve_order(ED)) for _ in range(n)]
        scalars = [rng.randrange(0, 1 << 253) for _ in range(n)]
        pts = [crv.ed_to_affine(crv.ed_scalar_mult(crv.ED_GENERATOR, k))
               for k in ks]
        np.savez_compressed(
            d / f"bench-edwards_bls12-{power}-bench-{power}.npz",
            point_words=np.stack([ints_to_words([p[0] for p in pts], 8),
                                  ints_to_words([p[1] for p in pts], 8)]),
            scalar_words=ints_to_words(scalars, 8))
    return str(d)


def use_case_cache(monkeypatch, cache: str) -> None:
    """make_bench_case reads its words from `cache`."""
    real = TD.make_bench_case

    def make(curve, power, seed=None, device=None, cache_dir=None):
        return real(curve, power, seed, device, cache_dir or cache)
    monkeypatch.setattr(TD, "make_bench_case", make)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return write_bench_cases(tmp_path_factory.mktemp("autotune-cache"),
                             (6, 8))


@pytest.fixture
def cached_cases(cache, monkeypatch):
    use_case_cache(monkeypatch, cache)
    autotune._bench_case.cache_clear()
    yield
    autotune._bench_case.cache_clear()


def test_a_real_tuning_run_on_the_cpu(table_dir, cached_cases):
    """autotune_chunk at n = 2^8 with the real measurement (the bench
    case, every result checked, the plain forms) picks a candidate and
    persists it with both timings."""
    w = autotune.autotune_chunk(ED, 1 << 8, candidates=(4, 5), runs=1,
                                device="cpu")
    entry = read_table(table_dir)["cpu/cpu"]["EDWARDS_BLS12"]["256"]
    assert w in (4, 5) and entry["chunk"] == w
    assert set(entry["warm_s"]) == {"4", "5"}
    assert all(t > 0 for t in entry["warm_s"].values())
    assert engine(ED)._chunk_for(1 << 8) == w


def test_a_wrong_result_stops_the_run(table_dir, cached_cases, monkeypatch):
    """With _finalize giving a wrong point, the real measurement raises
    AssertionError out of the tuning run, and nothing is persisted."""
    monkeypatch.setattr(CuzkMsmEngine, "_finalize",
                        lambda self, coords, chunk: {"x": 0, "y": 1})
    with pytest.raises(AssertionError, match="WRONG"):
        autotune.autotune_chunk(ED, 1 << 6, candidates=(4, 5), runs=1,
                                device="cpu")
    assert not (table_dir / ".autotune_torch.json").exists()


def test_cli_tunes_on_the_cpu(table_dir, cached_cases, capsys):
    autotune.main(["--powers", "6", "--curve", "edwards_bls12",
                   "--candidates", "5", "--runs", "1", "--tune", "chunk",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "2^6 edwards_bls12: chunk 5" in out
    assert autotune.lookup(ED, 1 << 6, device="cpu") == 5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_autotune_on_the_card(card, table_dir):
    """The real measurement at 2^16 on the card writes the table, and an
    engine resolves the winner from it."""
    w = autotune.autotune_chunk(G1, 1 << 16, runs=1)
    m, k = autotune.autotune_smvp(G1, 1 << 16, runs=1)
    entry = read_table(table_dir)[autotune.device_key(card)]["BLS12_377"][
        "65536"]
    assert entry["chunk"] == w and (entry["smvp"], entry["tree_finish"]) == (
        m, k)
    eng = CuzkMsmEngine(G1)
    assert eng._chunk_for(1 << 16) == w
    assert eng._select_smvp(w, 1 << 16) == m
    assert eng._tree_k(1 << 16) == (k or 2)
