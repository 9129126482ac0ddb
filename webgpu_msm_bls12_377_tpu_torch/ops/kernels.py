"""CUDA kernel build, loading and launch accounting; the lane-wise
kernels: 1 (constant product), 4 (lazy BPR family), 6 (legacy SMVP round)
and 7 (canonical add, double-and-add step, running-sum step).

Every kernel source under csrc/ is compiled by nvcc for sm_90a into a
shared library with a plain C interface, loaded with ctypes.  The build
runs at first use, one nvcc per source, all started together, into
<repo>/build/kernels/<hash of the sources>/ (listed in .gitignore), so a
fresh checkout builds everything the first time a kernel launches and a
changed source never reuses a stale library.  Importing this module
builds and loads nothing.

Every wrapper takes the plain PyTorch form of its kernel when its tensors
lie on the CPU, launches the kernel on PyTorch's current stream when they
lie on a CUDA device, and raises otherwise; it adds one to
``launches[name]`` for every kernel launch, so a run can show which
kernels it went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from . import curve as C
from . import field as F
from .field import NW

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("convert", "tree", "packed", "bpr", "stream", "legacy", "canon",
           "fused")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: kernel launches by wrapper name (reset with reset_launches)
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
#: C signature (after the leading pointers) of every entry point
_ARGTYPES = {
    "convert": {
        "msm_mont_mul_const": [_P, _P, _P, _I64, _I64, _P],
    },
    "tree": {
        "msm_tree_level_aff": [_P, _I64, _P, _P, _P, _I64, _INT, _P],
        "msm_tree_level_full": [_P, _I64, _P, _P, _I64, _INT, _P],
    },
    "packed": {
        "msm_packed_finish": [_P, _I64, _P, _P, _P, _I64, _P],
    },
    "bpr": {
        "msm_bpr_running_add": [_P, _P, _P, _P, _P, _I64, _P],
        "msm_bpr_double": [_P, _P, _I64, _P],
        "msm_bpr_masked_add_double": [_P, _P, _P, _P, _P, _I64, _P],
        "msm_bpr_add": [_P, _P, _P, _I64, _P],
    },
    "stream": {
        "msm_stream_buckets": [_P, _I64, _P, _P, _P, _P, _I64, _P],
    },
    "legacy": {
        "msm_masked_add_mixed": [_P, _P, _P, _P, _P, _I64, _P],
    },
    "canon": {
        "msm_fused_add": [_P, _P, _P, _I64, _P],
        "msm_masked_add_and_double": [_P, _P, _P, _P, _P, _I64, _P],
        "msm_fused_running_add": [_P, _P, _P, _P, _P, _I64, _P],
    },
    "fused": {
        "msm_fused_buckets": [_P, _P, _P, _P, _I64, _P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): cannot build kernels")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> tuple[Path, float]:
    """Compile every kernel source that has no library yet, in parallel.

    Returns (build directory, seconds spent compiling).  Each source's
    compiler output (ptxas registers and spills per kernel) is kept
    beside its library as <source>.log."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        lib = out_dir / f"libmsm_{name}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"libmsm_{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{log}")
        else:
            (out_dir / f"{name}.log").write_text(log)
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return out_dir, time.perf_counter() - t0


def _lib(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            out_dir, _ = build_all()
            for name in SOURCES:
                cdll = ctypes.CDLL(str(out_dir / f"libmsm_{name}.so"))
                cdll.msm_error_string.argtypes = [_INT]
                cdll.msm_error_string.restype = ctypes.c_char_p
                for fn, args in _ARGTYPES[name].items():
                    getattr(cdll, fn).argtypes = args
                    getattr(cdll, fn).restype = _INT
                _libs[name] = cdll
            lib = _libs[source]
    return lib


def launch(source: str, fn: str, name: str, threads: int, *args) -> None:
    """Call entry point fn of a kernel library with the current stream
    appended; raise on a nonzero launch status; count the launch.  With
    no threads to run the entry point launches nothing, so it is neither
    called nor counted."""
    if threads == 0:
        return
    lib = _lib(source)
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib, fn)(*args, stream)
    if code != 0:
        msg = lib.msm_error_string(code).decode()
        raise RuntimeError(f"{fn} failed to launch: {msg} ({code})")
    launches[name] += 1


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (checked: int32, contiguous, one device),
    False for CPU tensors; raises for any other device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"kernel operands must be contiguous int32, got {t.dtype}"
            )
    return True


def check_plane(t: torch.Tensor, rows: int, cols: int | None = None) -> int:
    if t.dim() != 2 or t.shape[0] != rows or (
        cols is not None and t.shape[1] != cols
    ):
        raise ValueError(f"expected a ({rows}, {cols}) plane, got {tuple(t.shape)}")
    return t.shape[1]


# ---------------------------------------------------------------------------
# Kernel 1: REDC(a * y) for a constant y
# ---------------------------------------------------------------------------


def mont_mul_const_plain(a: torch.Tensor, y: int) -> torch.Tensor:
    """(g*13, N) plane of g stacked field planes -> REDC(a * y) mod p
    each (canonical: REDC(a * y) < 2p for y < p)."""
    g = a.shape[0] // NW
    out = F.mont_mul(a.reshape(g, NW, -1).transpose(0, 1).reshape(NW, -1),
                     F.const_col(y, a.device))
    out = F.field_canon(out, 2)
    return out.reshape(NW, g, -1).transpose(0, 1).reshape(g * NW, -1)


def mont_mul_const(a: torch.Tensor, y: int) -> torch.Tensor:
    """REDC(a * y) mod p lane-wise over a (g*13, N) plane, for a constant
    y < p: y = R^2 mod p enters the Montgomery domain (to_mont), y = 1
    leaves it (from_mont).  Outputs are canonical."""
    if not 0 <= y < F.P:
        raise ValueError("the constant must be a canonical residue")
    if a.shape[0] % NW:
        raise ValueError(f"rows {a.shape[0]} not a multiple of {NW}")
    if not on_cuda(a):
        return mont_mul_const_plain(a, y)
    n = a.shape[1]
    out = torch.empty_like(a)
    y_words = np.array(
        [(y >> (32 * i)) & 0xFFFFFFFF for i in range(NW)], dtype=np.uint32
    )
    launch(
        "convert", "msm_mont_mul_const", "mont_mul_const", a.numel() // NW,
        a.data_ptr(), out.data_ptr(), y_words.ctypes.data,
        a.shape[0] // NW, n,
    )
    return out


# ---------------------------------------------------------------------------
# Kernel 4: the BPR family on (39, L) lazy projective planes
# ---------------------------------------------------------------------------

G1 = C.G1Ops()
ROWS = C.N_COORDS * NW
AFF_ROWS = 2 * NW


def running_add_plain(m, g, b):
    m2 = G1.add_lazy_pair(C.split(m), C.split(b))
    g2 = G1.add_lazy_pair(C.split(g), m2)
    return C.merge(m2), C.merge(g2)


def double_plain(a):
    return C.merge(G1.double_lazy(C.split(a)))


def masked_add_double_plain(r, t, bits):
    added = G1.add_lazy_pair(C.split(r), C.split(t))
    res = G1.select(bits != 0, added, C.split(r))
    return C.merge(res), C.merge(G1.double_lazy(C.split(t)))


def add_plain(a, b):
    return C.merge(G1.add_lazy_pair(C.split(a), C.split(b)))


def bpr_running_add(m, g, b):
    """One BPR stage-1 step: (m + b, g + (m + b))."""
    n = check_plane(m, ROWS)
    for t in (g, b):
        check_plane(t, ROWS, n)
    if not on_cuda(m, g, b):
        return running_add_plain(m, g, b)
    m2, g2 = torch.empty_like(m), torch.empty_like(g)
    launch("bpr", "msm_bpr_running_add", "bpr_running_add", n,
           m.data_ptr(), g.data_ptr(), b.data_ptr(), m2.data_ptr(),
           g2.data_ptr(), n)
    return m2, g2


def bpr_double(a):
    """Lazy doubling of every lane."""
    n = check_plane(a, ROWS)
    if not on_cuda(a):
        return double_plain(a)
    out = torch.empty_like(a)
    launch("bpr", "msm_bpr_double", "bpr_double", n,
           a.data_ptr(), out.data_ptr(), n)
    return out


def bpr_masked_add_double(r, t, bits):
    """One double-and-add step: (bit ? r + t : r, 2t); bits (L,) int32."""
    n = check_plane(r, ROWS)
    check_plane(t, ROWS, n)
    if bits.shape != (n,):
        raise ValueError(f"bits must be ({n},), got {tuple(bits.shape)}")
    if not on_cuda(r, t, bits):
        return masked_add_double_plain(r, t, bits)
    r2, t2 = torch.empty_like(r), torch.empty_like(t)
    launch("bpr", "msm_bpr_masked_add_double", "bpr_masked_add_double", n,
           r.data_ptr(), t.data_ptr(), bits.data_ptr(), r2.data_ptr(),
           t2.data_ptr(), n)
    return r2, t2


def bpr_add(a, b):
    """Lazy full add of every lane."""
    n = check_plane(a, ROWS)
    check_plane(b, ROWS, n)
    if not on_cuda(a, b):
        return add_plain(a, b)
    out = torch.empty_like(a)
    launch("bpr", "msm_bpr_add", "bpr_add", n,
           a.data_ptr(), b.data_ptr(), out.data_ptr(), n)
    return out


# ---------------------------------------------------------------------------
# Kernel 6: one lockstep round of the legacy SMVP
# ---------------------------------------------------------------------------


def masked_add_mixed_plain(acc, aff, sign_pos, valid):
    x, y = aff[:NW], aff[NW:]
    signed = (x, torch.where((sign_pos != 0)[None], y, F.field_neg(y)))
    new = G1.add_mixed(C.split(acc), signed)
    return C.merge(G1.select(valid != 0, new, C.split(acc)))


def masked_add_mixed(acc, aff, sign_pos, valid):
    """select(valid, acc + (sign_pos ? aff : -aff), acc), the canonical
    complete mixed add: acc (39, B) canonical, aff (26, B) canonical
    affine points (never the identity on a valid lane), sign_pos and valid
    (B,) int32."""
    n = check_plane(acc, ROWS)
    check_plane(aff, AFF_ROWS, n)
    for t in (sign_pos, valid):
        if t.shape != (n,):
            raise ValueError(f"lane flags must be ({n},), got {tuple(t.shape)}")
    if not on_cuda(acc, aff, sign_pos, valid):
        return masked_add_mixed_plain(acc, aff, sign_pos, valid)
    out = torch.empty_like(acc)
    launch("legacy", "msm_masked_add_mixed", "masked_add_mixed", n,
           acc.data_ptr(), aff.data_ptr(), sign_pos.data_ptr(),
           valid.data_ptr(), out.data_ptr(), n)
    return out


# ---------------------------------------------------------------------------
# Kernel 7: the canonical-domain kernels on (39, L) planes below p
# ---------------------------------------------------------------------------


def fused_add_plain(a, b):
    return C.merge(G1.add(C.split(a), C.split(b)))


def masked_add_and_double_plain(r, t, bits):
    added = G1.add(C.split(r), C.split(t))
    res = G1.select(bits != 0, added, C.split(r))
    return C.merge(res), C.merge(G1.double(C.split(t)))


def fused_running_add_plain(m, g, b):
    m2 = G1.add(C.split(m), C.split(b))
    g2 = G1.add(C.split(g), m2)
    return C.merge(m2), C.merge(g2)


def fused_add(a, b):
    """Canonical complete add of every lane."""
    n = check_plane(a, ROWS)
    check_plane(b, ROWS, n)
    if not on_cuda(a, b):
        return fused_add_plain(a, b)
    out = torch.empty_like(a)
    launch("canon", "msm_fused_add", "fused_add", n,
           a.data_ptr(), b.data_ptr(), out.data_ptr(), n)
    return out


def masked_add_and_double(r, t, bits):
    """One canonical double-and-add step: (bit ? r + t : r, 2t); bits (L,)
    int32."""
    n = check_plane(r, ROWS)
    check_plane(t, ROWS, n)
    if bits.shape != (n,):
        raise ValueError(f"bits must be ({n},), got {tuple(bits.shape)}")
    if not on_cuda(r, t, bits):
        return masked_add_and_double_plain(r, t, bits)
    r2, t2 = torch.empty_like(r), torch.empty_like(t)
    launch("canon", "msm_masked_add_and_double", "masked_add_and_double", n,
           r.data_ptr(), t.data_ptr(), bits.data_ptr(), r2.data_ptr(),
           t2.data_ptr(), n)
    return r2, t2


def fused_running_add(m, g, b):
    """One canonical running-sum step: (m + b, g + (m + b))."""
    n = check_plane(m, ROWS)
    for t in (g, b):
        check_plane(t, ROWS, n)
    if not on_cuda(m, g, b):
        return fused_running_add_plain(m, g, b)
    m2, g2 = torch.empty_like(m), torch.empty_like(g)
    launch("canon", "msm_fused_running_add", "fused_running_add", n,
           m.data_ptr(), g.data_ptr(), b.data_ptr(), m2.data_ptr(),
           g2.data_ptr(), n)
    return m2, g2
