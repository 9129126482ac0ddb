"""The port's build cache (utils/build_cache.py) under the kernel build
(ops/kernels.py), with no nvcc here: $MSM_BUILD_DIR moves the kernels'
build directory, the variants' root and tools/row_times.py's sass
directory; the key follows the toolkit id, which is nvcc's --version
(read once a process) and "none" where there is no nvcc; a compiler that
cannot say its version raises; a CPU run keys its directory without
running any compiler.  A stand-in "nvcc" shell script answers --version
and writes the source's name to -o's file.
"""

import importlib.util
import subprocess
from pathlib import Path

import pytest

from webgpu_msm_bls12_377_tpu_torch.ops import kernels as K
from webgpu_msm_bls12_377_tpu_torch.utils import build_cache

ROOT = Path(__file__).resolve().parents[1]


def stand_in(path: Path, version: str = "stand-in nvcc 1.0") -> str:
    path.write_text(
        "#!/bin/sh\n"
        f"if [ \"$1\" = --version ]; then echo \"{version}\"; exit 0; fi\n"
        "out=\nsrc=\nwhile [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=$2; shift; else src=$1; fi\n"
        "  shift\ndone\necho \"$src\" > \"$out\"\n")
    path.chmod(0o755)
    return str(path)


def row_times():
    spec = importlib.util.spec_from_file_location(
        "row_times", ROOT / "tools" / "row_times.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_nvcc(tmp_path, monkeypatch):
    """No nvcc to find (CUDA_HOME and PATH name an empty directory), and
    any compiler run fails the test."""
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("CUDA_HOME", str(empty))
    monkeypatch.setenv("PATH", str(empty))

    def refuse(*a, **k):
        pytest.fail(f"a compiler ran: {a}")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)


def test_build_dir_override_moves_every_kernel_build(tmp_path, monkeypatch,
                                                     no_nvcc):
    monkeypatch.delenv("MSM_BUILD_DIR", raising=False)
    default = K._build_dir()
    assert default.parent == K.BUILD_ROOT == build_cache.DEFAULT_ROOT / "kernels"
    assert row_times().sass_dir(K) == build_cache.DEFAULT_ROOT / "sass"
    monkeypatch.setenv("MSM_BUILD_DIR", str(tmp_path / "b"))
    assert build_cache.build_root() == tmp_path / "b"
    assert K._build_dir() == tmp_path / "b" / "kernels" / default.name
    assert row_times().sass_dir(K) == tmp_path / "b" / "sass"


def test_variants_follow_the_build_root(tmp_path, monkeypatch):
    monkeypatch.setattr(K, "_nvcc", lambda: stand_in(tmp_path / "nvcc"))
    monkeypatch.setenv("MSM_BUILD_DIR", str(tmp_path / "b"))
    dirs = K.build_variants(("tree",), {"c_form": ("-DMSM_MONT_C",)})
    key = K._build_dir().name
    assert dirs == {"c_form": tmp_path / "b" / "variants" / key / "tree" /
                    "c_form"}
    assert sorted(p.name for p in dirs["c_form"].iterdir()) == [
        "libmsm_tree.so", "libmsm_tree_ed.so", "tree.log", "tree_ed.log"]


def test_without_nvcc_the_build_dir_resolves(no_nvcc):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K._nvcc()
    assert K._toolkit() == build_cache.NO_TOOLKIT
    assert K._build_dir().name == build_cache.key(
        sorted(K.CSRC.iterdir()), K.NVCC_FLAGS, build_cache.NO_TOOLKIT)


def test_a_changed_toolkit_changes_the_key(tmp_path, monkeypatch):
    """Two stand-ins that differ only in their --version give two
    directories, neither that of no toolkit; each --version is read once."""
    names = []
    for version in ("cuda 12.4", "cuda 12.8"):
        nvcc = stand_in(tmp_path / version.replace(" ", "_"), version)
        monkeypatch.setattr(K, "_nvcc", lambda nvcc=nvcc: nvcc)
        assert build_cache.toolkit_id(nvcc) == version
        names.append(K._build_dir().name)
    assert len(set(names)) == 2
    assert build_cache.key(sorted(K.CSRC.iterdir()), K.NVCC_FLAGS,
                           build_cache.NO_TOOLKIT) not in names
    calls = []
    real = subprocess.run
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    K._build_dir()
    assert calls == []


def test_a_compiler_without_a_version_raises(tmp_path):
    bad = tmp_path / "cc"
    bad.write_text("#!/bin/sh\nexit 3\n")
    bad.chmod(0o755)
    with pytest.raises(RuntimeError, match="--version failed"):
        build_cache.toolkit_id(str(bad))
    assert build_cache.toolkit_id(None) == build_cache.NO_TOOLKIT


def test_publish_replaces_in_one_rename(tmp_path):
    dest = tmp_path / "lib.so"
    dest.write_text("old")
    tmp = build_cache.staging(dest)
    assert tmp.parent == tmp_path and tmp.name.startswith("lib.so.tmp")
    tmp.write_text("new")
    build_cache.publish(tmp, dest)
    assert dest.read_text() == "new" and not tmp.exists()
