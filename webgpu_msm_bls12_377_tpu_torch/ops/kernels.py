"""CUDA kernel build, loading and launch accounting; the lane-wise
kernels: 1 (the point prep: wire words to the Montgomery table or the
signed table in one launch; and the constant product of the Montgomery
exit), 4 (lazy BPR family: stage 1, stage 2 and the window fold, each in
one launch, and the lane-wise add), 6 (the legacy SMVP: every segment's
canonical sum in one launch) and 7 (canonical: the whole double-and-add
of a scalar multiplication, the whole tree sum and the whole running-sum
chain, one launch each), and tree.cu's Montgomery products on their own
(field_mul_lanes) and its rate kernel (word_rate).

Every kernel source under csrc/ is compiled by nvcc for sm_90a into a
shared library with a plain C interface, loaded with ctypes, and a second
time with -DMSM_CURVE_ED, for the Edwards field and curve
(libmsm_<source>_ed.so): 16 libraries, 38 entry points.  The build runs
at first use, one nvcc per library, all started together, into
kernels_root()/<key>/: kernels_root() is $MSM_BUILD_DIR/kernels where that
is set, else BUILD_ROOT (<repo>/build/kernels, listed in .gitignore), and
the key (utils/build_cache.py) hashes the sources, NVCC_FLAGS and nvcc's
--version, so a fresh checkout builds everything the first time a kernel
launches, and a changed source or CUDA release never reuses a stale
library.  build_variants builds a source again with extra nvcc flags (the
C-form product, register budgets) into variants/ beside kernels_root(),
and `using` launches through such a build.  Importing this module builds
and loads nothing, and keying a directory where there is no nvcc runs
none.

Every wrapper takes the plain PyTorch form of its kernel when its tensors
lie on the CPU, launches the kernel on their CUDA device, with that device
entered and on its current stream, when they lie on one, and raises
otherwise; it adds one to
``launches[name]`` for every kernel launch, so a run can show which
kernels it went through.  Wrappers take the group (ops/curve.py: G1, the
default, or EDWARDS) or the field; an Edwards launch counts under the name
with "_ed" appended.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..utils import build_cache
from . import curve as C
from . import field as F
from .convert import WireLayout, limbs_from_u32_words
from .curve import G1
from .field import ED_CTX, G1_CTX, FieldCtx

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: the kernels root where $MSM_BUILD_DIR is unset (kernels_root)
BUILD_ROOT = build_cache.DEFAULT_ROOT / "kernels"
SOURCES = ("convert", "tree", "packed", "bpr", "stream", "legacy", "canon",
           "fused")
#: every library, each source for G1 and for Edwards: (library name,
#: source, extra nvcc flags)
LIBRARIES = tuple((s, s, ()) for s in SOURCES) + tuple(
    (s + ED_CTX.tag, s, ("-DMSM_CURVE_ED",)) for s in SOURCES)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: kernel launches by wrapper name (reset with reset_launches)
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
#: C signature of every exported function: the entry points, the stream
#: last, and msm_tree_sum_scratch, the words of the tree sum's scratch
_ARGTYPES = {
    "convert": {
        "msm_point_prep": [_P, _P, _I64, _I64, _I64, _I64, _INT, _P, _P],
        "msm_mont_mul_const": [_P, _P, _P, _I64, _I64, _P],
    },
    "tree": {
        "msm_tree_level_aff": [_P, _I64, _P, _P, _P, _I64, _INT, _P],
        "msm_tree_level_full": [_P, _I64, _P, _P, _I64, _INT, _P],
        "msm_fold_pieces": [_P, _I64, _P, _P, _P, _P, _I64, _P],
        "msm_fold_split": [_P, _I64, _P, _P, _P, _P, _P, _P, _I64, _I64,
                           _INT, _P, _P],
        "msm_field_mul_lanes": [_P, _P, _P, _P, _P, _P, _I64, _P],
        "msm_word_rate": [_P, _I64, _INT, _P],
    },
    "packed": {
        "msm_packed_finish": [_P, _P, _P, _P, _P, _I64, _P, _I64, _P],
    },
    "bpr": {
        "msm_bpr_stage1": [_P, _P, _P, _I64, _INT, _INT, _P],
        "msm_bpr_stage2": [_P, _P, _P, _I64, _INT, _INT, _P],
        "msm_bpr_fold": [_P, _P, _I64, _INT, _P],
        "msm_bpr_add": [_P, _P, _P, _I64, _P],
    },
    "stream": {
        "msm_stream_buckets": [_P, _I64, _P, _P, _P, _P, _I64, _P],
    },
    "legacy": {
        "msm_legacy_buckets": [_P, _I64, _P, _P, _P, _P, _I64, _P],
    },
    "canon": {
        "msm_scalar_mult": [_P, _P, _INT, _P, _I64, _P],
        "msm_running_sum": [_P, _P, _P, _INT, _P, _P, _I64, _P],
        "msm_tree_sum": [_P, _P, _P, _I64, _P],
        "msm_tree_sum_scratch": [_I64],
    },
    "fused": {
        "msm_fused_buckets": [_P, _P, _P, _P, _I64, _P],
    },
}
_ARGTYPES.update({s + ED_CTX.tag: dict(_ARGTYPES[s]) for s in SOURCES})

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


def kernels_root() -> Path:
    """$MSM_BUILD_DIR/kernels where that is set, else BUILD_ROOT."""
    if os.environ.get(build_cache.ENV):
        return build_cache.build_root() / "kernels"
    return BUILD_ROOT


def _toolkit() -> str:
    """nvcc's toolkit id, build_cache.NO_TOOLKIT where there is no nvcc."""
    try:
        nvcc = _nvcc()
    except RuntimeError:
        return build_cache.NO_TOOLKIT
    return build_cache.toolkit_id(nvcc)


def _build_dir() -> Path:
    return kernels_root() / build_cache.key(sorted(CSRC.iterdir()),
                                            NVCC_FLAGS, _toolkit())


def build_all(out_dir: Path | None = None) -> tuple[Path, float]:
    """Compile every library that is not built yet in out_dir (default:
    _build_dir(), the directory of these sources, flags and nvcc), in
    parallel, each published with one rename (build_cache.publish).

    Returns (build directory, seconds spent compiling).  Each library's
    compiler output (ptxas registers and spills per kernel) is kept
    beside it as <library>.log."""
    out_dir = _build_dir() if out_dir is None else out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, source, flags in LIBRARIES:
        lib = out_dir / f"libmsm_{name}.so"
        if lib.exists():
            continue
        tmp = build_cache.staging(lib)
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp),
               str(CSRC / f"{source}.cu")]
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
            build_cache.publish(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return out_dir, time.perf_counter() - t0


def rebuild() -> tuple[Path, float]:
    """Compile every library again from csrc/ into _build_dir()
    (compute_msm's force_recompile) and forget the loaded ones, so that
    the next launch loads the new builds.

    The libraries are built in a fresh directory and each is then moved
    over its old build with one rename: another process of this checkout
    that builds or loads them meanwhile finds a whole library, old or new,
    and never a missing one.  A process that has loaded them keeps the
    copies it loaded, which the same sources make identical."""
    out_dir = _build_dir()
    fresh = out_dir.with_name(f"{out_dir.name}.rebuild{os.getpid()}")
    with _lock:
        shutil.rmtree(fresh, ignore_errors=True)
        try:
            _, secs = build_all(fresh)
            out_dir.mkdir(parents=True, exist_ok=True)
            for name, _, _ in LIBRARIES:
                for f in (f"{name}.log", f"libmsm_{name}.so"):
                    os.replace(fresh / f, out_dir / f)
        finally:
            shutil.rmtree(fresh, ignore_errors=True)
        _libs.clear()
    return out_dir, secs


def build_variants(sources: tuple[str, ...],
                   variants: dict[str, tuple[str, ...]]) -> dict[str, Path]:
    """Build the libraries of `sources` (both fields of each) again with
    each variant's extra nvcc flags (-DMSM_MONT_C: the C-form product; a
    source's register-budget macros), those not built yet, every nvcc
    started together, into
    variants/<key of the default build>/<sources>/<variant>/ beside
    kernels_root().  Returns {variant: directory}; load_variant loads a
    directory."""
    root = kernels_root().parent / "variants" / _build_dir().name
    procs, dirs = [], {}
    for v, flags in variants.items():
        d = dirs[v] = root / "_".join(sources) / v
        d.mkdir(parents=True, exist_ok=True)
        for name, source, cflags in LIBRARIES:
            lib = d / f"libmsm_{name}.so"
            if source not in sources or lib.exists():
                continue
            tmp = build_cache.staging(lib)
            cmd = [_nvcc(), *NVCC_FLAGS, *cflags, *flags, "-o", str(tmp),
                   str(CSRC / f"{source}.cu")]
            procs.append((d, name, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    errors = []
    for d, name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{name} in {d}:\n{log}")
            continue
        (d / f"{name}.log").write_text(log)
        build_cache.publish(tmp, lib)
    if errors:
        raise RuntimeError("variant build failed:\n" + "\n".join(errors))
    return dirs


def load_variant(out_dir: Path, sources: tuple[str, ...]
                 ) -> dict[str, ctypes.CDLL]:
    """The libraries of `sources` built in out_dir by build_variants:
    {library name: CDLL}."""
    return {name: load_library(out_dir, name) for name, source, _ in LIBRARIES
            if source in sources}


@contextlib.contextmanager
def using(libs: dict[str, ctypes.CDLL]):
    """Inside the block, launches of the named libraries go through the
    given ones (a variant build) in place of the default build's."""
    saved = {name: _lib(name) for name in libs}
    with _lock:
        _libs.update(libs)
    try:
        yield
    finally:
        with _lock:
            _libs.update(saved)


def load_library(out_dir: Path, name: str) -> ctypes.CDLL:
    """Load library `name` built in out_dir, its entry points' C
    signatures declared."""
    cdll = ctypes.CDLL(str(out_dir / f"libmsm_{name}.so"))
    cdll.msm_error_string.argtypes = [_INT]
    cdll.msm_error_string.restype = ctypes.c_char_p
    for fn, args in _ARGTYPES[name].items():
        getattr(cdll, fn).argtypes = args
        getattr(cdll, fn).restype = _INT
    return cdll


def _lib(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            out_dir, _ = build_all()
            for name, _, _ in LIBRARIES:
                _libs[name] = load_library(out_dir, name)
            lib = _libs[source]
    return lib


def launch(library: str, fn: str, name: str, threads: int, *args,
           device: torch.device | None = None) -> None:
    """Call entry point fn of a kernel library on `device`, the operands'
    CUDA device, with that device's current stream appended; raise on a
    nonzero launch status; count the launch.  The call runs with the
    device entered: the libraries link nvcc's static CUDA runtime, which
    follows the thread's current context, so a launch on operands of
    cuda:1 while cuda:0 is current would otherwise run on the wrong
    device.  With no threads to run the entry point launches nothing, so
    it is neither called nor counted."""
    if threads == 0:
        return
    if device is None or torch.device(device).type != "cuda":
        raise ValueError(f"{fn}: a launch needs its operands' CUDA device, "
                         f"got {device}")
    lib = _lib(library)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
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
# Kernel 1: the point prep (Montgomery entry) and REDC(a * y) for a
# constant y (the exit)
# ---------------------------------------------------------------------------

#: words of one signed-table row: G1 x, y and six zero words; Edwards x, y,
#: t and five zero words (the fused path's row, ops/smvp_kernel.py)
ROW_WORDS = 32
#: point_prep's forms (csrc/convert.cu PREP_SIGNED, PREP_PLANE): the
#: (2N, ROW_WORDS) signed table of the tree and stream paths, or the
#: (26|27, N) Montgomery table of the others
SIGNED, PLANE = 0, 1


def _words(v: int, nw: int) -> np.ndarray:
    """v as nw little-endian u32 words (a kernel's constant operand)."""
    return np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(nw)],
                    dtype=np.uint32)


def build_signed_table(table: torch.Tensor, group=G1) -> torch.Tensor:
    """Montgomery affine table -> row-major signed table (2N, ROW_WORDS)
    int32: rows [0, N) hold the points, rows [N, 2N) their negatives
    (G1: (x, y), then (x, -y); Edwards: (x, y, t), then (-x, y, -t)), the
    affine coordinates in words [0, aff_rows) and zeros after them (the
    fused path's 32-word row, 16-byte aligned, so a kernel reads a row as
    seven 16-byte loads).  One table serves the stream kernel and tree
    level 1; point_prep builds it in its one launch."""
    n = check_plane(table, group.aff_rows)
    neg = C.merge(group.neg_affine(group.split_aff(table)))
    out = torch.zeros((2 * n, ROW_WORDS), dtype=torch.int32,
                      device=table.device)
    out[:n, :group.aff_rows] = table.T
    out[n:, :group.aff_rows] = neg.T
    return out


def point_prep_plain(words: torch.Tensor, layout: WireLayout, group=G1,
                     out: int = SIGNED) -> torch.Tensor:
    """Plain form of point_prep: the wire words made word-major, a zero
    top word appended (limbs_from_u32_words), kernel 1's entry
    (mont_mul_const_plain with R^2 mod p), for Edwards t = x*y
    (mont_mul_canon), then the signed table (build_signed_table) or the
    Montgomery table itself."""
    ctx = group.ctx
    limbs = limbs_from_u32_words(layout.word_major(words), ctx.nw)
    table = mont_mul_const_plain(limbs.reshape(-1, layout.n), ctx.params.r2,
                                 ctx)
    if group is not G1:
        nw = ctx.nw
        table = torch.cat([table, F.mont_mul_canon(table[:nw], table[nw:],
                                                   ctx)])
    return table if out == PLANE else build_signed_table(table, group)


def point_prep(words: torch.Tensor, layout: WireLayout, group=G1,
               out: int = SIGNED) -> torch.Tensor:
    """The point prep in one launch: wire words (int32 bits of the u32
    words, in `layout`: word-major (2, k, N) or point-major (N, 2k), k = 12
    for G1, 8 for Edwards) -> out SIGNED: the (2N, ROW_WORDS) signed table
    (build_signed_table's), or PLANE: the canonical Montgomery affine
    table, G1 (26, N) (x; y), Edwards (27, N) (x; y; t = x*y)."""
    ctx = group.ctx
    if layout.coords != 2 or layout.k != ctx.nw - 1:
        raise ValueError(f"expected {ctx.nw - 1} words a coordinate of x "
                         f"and y, got {layout.coords} of {layout.k}")
    if tuple(words.shape) != layout.shape:
        raise ValueError(f"words of shape {tuple(words.shape)} do not have "
                         f"the layout's {layout.shape}")
    if out not in (SIGNED, PLANE):
        raise ValueError(f"unknown point prep form {out}")
    if not on_cuda(words):
        return point_prep_plain(words, layout, group, out)
    n = layout.n
    shape = (2 * n, ROW_WORDS) if out == SIGNED else (group.aff_rows, n)
    res = torch.empty(shape, dtype=torch.int32, device=words.device)
    r2 = _words(ctx.params.r2, ctx.nw)
    launch("convert" + ctx.tag, "msm_point_prep", "point_prep" + ctx.tag, n,
           words.data_ptr(), res.data_ptr(), n, *layout.strides(), out,
           r2.ctypes.data, device=res.device)
    return res


def mont_mul_const_plain(a: torch.Tensor, y: int,
                         ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """(g*nw, N) plane of g stacked field planes -> REDC(a * y) mod p
    each (canonical: REDC(a * y) < 2p for y < p)."""
    nw = ctx.nw
    g = a.shape[0] // nw
    out = F.mont_mul_canon(
        a.reshape(g, nw, -1).transpose(0, 1).reshape(nw, -1),
        ctx.col(y, a.device), ctx)
    return out.reshape(nw, g, -1).transpose(0, 1).reshape(g * nw, -1)


def mont_mul_const(a: torch.Tensor, y: int,
                   ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """REDC(a * y) mod p lane-wise over a (g*nw, N) plane, for a constant
    y < p: y = 1 leaves the Montgomery domain (from_mont; the window sums'
    exit), y = R^2 mod p enters it (to_mont).  Outputs are canonical."""
    nw = ctx.nw
    if not 0 <= y < ctx.p:
        raise ValueError("the constant must be a canonical residue")
    if a.shape[0] % nw:
        raise ValueError(f"rows {a.shape[0]} not a multiple of {nw}")
    if not on_cuda(a):
        return mont_mul_const_plain(a, y, ctx)
    n = a.shape[1]
    out = torch.empty_like(a)
    y_words = _words(y, nw)
    launch(
        "convert" + ctx.tag, "msm_mont_mul_const", "mont_mul_const" + ctx.tag,
        a.numel() // nw, a.data_ptr(), out.data_ptr(), y_words.ctypes.data,
        a.shape[0] // nw, n, device=out.device,
    )
    return out


def field_mul_lanes_plain(a, b, c, d, ctx: FieldCtx = G1_CTX):
    return F.mont_mul(a, b, ctx), F.mont_mul_pair(a, b, c, d, ctx)


def field_mul_lanes(a, b, c, d, ctx: FieldCtx = G1_CTX):
    """(REDC(a*b), REDC(a*b + c*d)) mod R lane-wise over four (nw, N)
    planes of any values below R: the Montgomery products that
    csrc/tree.cu (and stream.cu) build, on their own, for holding them
    against ops/field.py at extreme operands."""
    n = check_plane(a, ctx.nw)
    for t in (b, c, d):
        check_plane(t, ctx.nw, n)
    if not on_cuda(a, b, c, d):
        return field_mul_lanes_plain(a, b, c, d, ctx)
    prod, pair = torch.empty_like(a), torch.empty_like(a)
    launch("tree" + ctx.tag, "msm_field_mul_lanes",
           "field_mul_lanes" + ctx.tag, n, a.data_ptr(), b.data_ptr(),
           c.data_ptr(), d.data_ptr(), prod.data_ptr(), pair.data_ptr(), n,
           device=prod.device)
    return prod, pair


#: threads of a block of tree.cu's rate kernel (its RATE_THREADS)
RATE_THREADS = 256


def word_rate_plain(lanes: int, iters: int, ctx: FieldCtx = G1_CTX,
                    device=None) -> torch.Tensor:
    """Plain form of word_rate's output for lanes 0 .. lanes - 1: lane s
    starts from words x_k = s 2654435761 + 40503 k + 1 and y_k = x_k ^
    0x9e3779b9 (mod 2^32), runs x = REDC(x y) mod R `iters` times, and
    gives the xor of x's words."""
    seed = torch.arange(lanes, dtype=torch.int64, device=device)
    k = torch.arange(ctx.nw, dtype=torch.int64, device=device)[:, None]
    x = (seed[None] * 2654435761 + k * 40503 + 1) & F.M32
    y = F._i32(x ^ 0x9E3779B9)
    x = F._i32(x)
    for _ in range(iters):
        x = F.mont_mul(x, y, ctx)
    s = x[0]
    for i in range(1, ctx.nw):
        s = s ^ x[i]
    return s


def word_rate(out: torch.Tensor, iters: int,
              ctx: FieldCtx = G1_CTX) -> torch.Tensor:
    """tree.cu's rate kernel (msm_word_rate): out.numel() / RATE_THREADS
    blocks of RATE_THREADS threads, each running `iters` dependent
    Montgomery products, 2 nw^2 word products each, in the source's
    product form (the carry chain, or the C form in a -DMSM_MONT_C
    variant build: launch inside `using`); writes each thread's xor of its
    words to out (word_rate_plain) and returns it."""
    if out.dim() != 1 or out.numel() % RATE_THREADS:
        raise ValueError(f"out must hold whole blocks of {RATE_THREADS} "
                         f"lanes, got {tuple(out.shape)}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if not on_cuda(out):
        return out.copy_(word_rate_plain(out.numel(), iters, ctx, out.device))
    blocks = out.numel() // RATE_THREADS
    launch("tree" + ctx.tag, "msm_word_rate", "word_rate" + ctx.tag, blocks,
           out.data_ptr(), blocks, iters, device=out.device)
    return out


# ---------------------------------------------------------------------------
# Kernel 4: the BPR family on lazy projective planes ((39, L) G1, (36, L)
# Edwards)
# ---------------------------------------------------------------------------

def running_add_plain(m, g, b, group=G1):
    m2 = group.add_lazy(group.split(m), group.split(b))
    g2 = group.add_lazy(group.split(g), m2)
    return C.merge(m2), C.merge(g2)


def double_plain(a, group=G1):
    return C.merge(group.double_lazy(group.split(a)))


def add_plain(a, b, group=G1):
    return C.merge(group.add_lazy(group.split(a), group.split(b)))


def bpr_stage1_plain(buckets, bpt, split, group=G1):
    """Plain form of bpr_stage1, in its order of adds: the running add
    over each sub-walk's q = bpt / split steps (lane-wise over all
    sub-walks at once), then per lane a running add over m_0 .. m_{S-2}
    (A the running sum, W the sum of A's values), m = A + m_{S-1}, log2 q
    lazy doublings of W, g = ((g_0 + g_1) + ...) + g_{S-1} + W."""
    rows, lanes = group.rows, buckets.shape[1] // bpt
    q = bpt // split
    walks = buckets.reshape(rows, split, q, lanes)
    m = g = walks[:, :, 0].reshape(rows, split * lanes)
    for i in range(1, q):
        m, g = running_add_plain(
            m, g, walks[:, :, i].reshape(rows, split * lanes), group)
    if split > 1:
        ms = [m[:, k * lanes:(k + 1) * lanes] for k in range(split)]
        gs = [g[:, k * lanes:(k + 1) * lanes] for k in range(split)]
        m = w = ms[0]
        for k in range(1, split - 1):
            m = add_plain(m, ms[k], group)
            w = add_plain(w, m, group)
        m = add_plain(m, ms[-1], group)
        for _ in range(q.bit_length() - 1):
            w = double_plain(w, group)
        g = gs[0]
        for k in range(1, split):
            g = add_plain(g, gs[k], group)
        g = add_plain(g, w, group)
    return m.contiguous(), g.contiguous()


#: the most sub-walks a lane's stage-1 walk is split into (a block holds
#: 128 / split lanes)
MAX_SPLIT = 8


def bpr_stage1(buckets, bpt, split, group=G1):
    """BPR stage 1 in one launch: buckets (39|36, bpt*lanes) in walk
    order (column st*lanes + lane: the bucket lane consumes at step st) ->
    (m, g), each (39|36, lanes): m the sum of a lane's bpt buckets, g the
    sum over steps st of the sum of its buckets 0..st (the TPU's bpt - 1
    running adds from m = g = step 0's bucket).  Each lane's walk runs as
    `split` sub-walks (a power of two dividing bpt, at most MAX_SPLIT),
    combined exactly; split = 1 is the TPU walk word for word, a larger
    split gives the same points in other projective coordinates."""
    if bpt < 1 or bpt & (bpt - 1):
        raise ValueError(f"bpt must be a power of two, got {bpt}")
    if split < 1 or split & (split - 1) or split > min(bpt, MAX_SPLIT):
        raise ValueError(f"split must be a power of two <= min(bpt, "
                         f"{MAX_SPLIT}), got {split}")
    cols = check_plane(buckets, group.rows)
    if cols % bpt:
        raise ValueError(f"{cols} columns are not bpt = {bpt} steps")
    lanes = cols // bpt
    if not on_cuda(buckets):
        return bpr_stage1_plain(buckets, bpt, split, group)
    m = torch.empty((group.rows, lanes), dtype=torch.int32,
                    device=buckets.device)
    g = torch.empty_like(m)
    tag = group.ctx.tag
    launch("bpr" + tag, "msm_bpr_stage1", "bpr_stage1" + tag, lanes * split,
           buckets.data_ptr(), m.data_ptr(), g.data_ptr(), lanes, bpt, split,
           device=m.device)
    return m, g


def bpr_stage2_plain(m, g, t_count, bpt, group=G1):
    """Plain form of bpr_stage2, in its order of operations: b = log2(bpt)
    lazy doublings of m into temp, then for each bit of k = t_count - 1 -
    t (t = lane mod t_count), low bit first, g + temp where the bit is set
    (lane-wise select) and temp doubled, but after the top bit."""
    lanes = m.shape[1]
    k = t_count - 1 - torch.arange(lanes, device=m.device) % t_count
    temp = m
    for _ in range(bpt.bit_length() - 1):
        temp = double_plain(temp, group)
    nbits = max((t_count - 1).bit_length(), 1)
    for i in range(nbits):
        added = group.add_lazy(group.split(g), group.split(temp))
        g = C.merge(group.select(((k >> i) & 1) != 0, added, group.split(g)))
        if i < nbits - 1:
            temp = double_plain(temp, group)
    return g


def bpr_stage2(m, g, t_count, bpt, group=G1):
    """BPR stage 2 in one launch: g + (k << b) * m lane-wise over (39|36,
    lanes) lazy planes, lanes = windows * t_count window-major, k = t_count
    - 1 - t for the lane's thread t within its window and b = log2(bpt):
    the TPU's b lazy doublings and double-and-add steps, one thread a
    lane.  Returns the new g."""
    lanes = check_plane(m, group.rows)
    check_plane(g, group.rows, lanes)
    for name, v in (("t_count", t_count), ("bpt", bpt)):
        if v < 1 or v & (v - 1):
            raise ValueError(f"{name} must be a power of two, got {v}")
    if lanes % t_count:
        raise ValueError(f"{lanes} lanes are not whole windows of {t_count}")
    if not on_cuda(m, g):
        return bpr_stage2_plain(m, g, t_count, bpt, group)
    out = torch.empty_like(g)
    tag = group.ctx.tag
    launch("bpr" + tag, "msm_bpr_stage2", "bpr_stage2" + tag, lanes,
           m.data_ptr(), g.data_ptr(), out.data_ptr(), lanes, t_count,
           bpt.bit_length() - 1, device=out.device)
    return out


#: the most lanes a window the fold kernel takes (csrc/bpr.cu FOLD_THREADS
#: << FOLD_STACK): chunk 16's 2^15 buckets a window, one a lane
MAX_FOLD_LANES = 128 << 8


def bpr_fold_plain(g, num_windows, t_count, group=G1):
    """Plain form of bpr_fold: the shift-reduce's adds that feed lane 0,
    level by level (lane i < off takes lane i + off, off = t_count / 2,
    ..., 1)."""
    x = g.reshape(group.rows, num_windows, t_count)
    off = t_count // 2
    while off >= 1:
        x = add_plain(x[:, :, :off].reshape(group.rows, -1),
                      x[:, :, off:2 * off].reshape(group.rows, -1), group
                      ).reshape(group.rows, num_windows, off)
        off //= 2
    return x[:, :, 0].contiguous()


def bpr_fold(g, num_windows, t_count, group=G1):
    """The window fold in one launch: (39|36, num_windows * t_count) lazy
    lanes, window-major -> (39|36, num_windows) lazy window sums, each the
    TPU's shift-reduce of its t_count lanes (the same pairs, the same
    words)."""
    if t_count < 1 or t_count & (t_count - 1):
        raise ValueError(f"t_count must be a power of two, got {t_count}")
    check_plane(g, group.rows, num_windows * t_count)
    if not on_cuda(g):
        return bpr_fold_plain(g, num_windows, t_count, group)
    if t_count > MAX_FOLD_LANES:
        raise ValueError(f"the fold kernel takes at most {MAX_FOLD_LANES} "
                         f"lanes a window, got {t_count}")
    out = torch.empty((group.rows, num_windows), dtype=torch.int32,
                      device=g.device)
    tag = group.ctx.tag
    launch("bpr" + tag, "msm_bpr_fold", "bpr_fold" + tag, num_windows,
           g.data_ptr(), out.data_ptr(), num_windows, t_count,
           device=out.device)
    return out


def bpr_add(a, b, group=G1):
    """Lazy full add of every lane, (39|36, L) planes below 4p (G1) or 2p
    (Edwards) in, the same bound out: the sharded engine's join of bucket
    partials and of window sums (parallel/mesh.py)."""
    n = check_plane(a, group.rows)
    check_plane(b, group.rows, n)
    if not on_cuda(a, b):
        return add_plain(a, b, group)
    out = torch.empty_like(a)
    tag = group.ctx.tag
    launch("bpr" + tag, "msm_bpr_add", "bpr_add" + tag, n,
           a.data_ptr(), b.data_ptr(), out.data_ptr(), n, device=out.device)
    return out


# ---------------------------------------------------------------------------
# Kernel 6's round (the legacy SMVP's plain form; the kernel, every
# segment's sum in one launch, is ops/buckets.py:legacy_buckets)
# ---------------------------------------------------------------------------


def masked_add_mixed_plain(acc, aff, sign_pos, valid, group=G1):
    """One lockstep round: select(valid, acc + (sign_pos ? aff : -aff),
    acc), the canonical complete mixed add (the TPU's masked_add_mixed)."""
    parts = group.split_aff(aff)
    neg = group.neg_affine(parts)
    pos = (sign_pos != 0)[None]
    signed = tuple(torch.where(pos, a, b) for a, b in zip(parts, neg))
    new = group.add_mixed(group.split(acc), signed)
    return C.merge(group.select(valid != 0, new, group.split(acc)))


# ---------------------------------------------------------------------------
# Kernel 7: the canonical-domain kernels on (39|36, L) planes below p
# ---------------------------------------------------------------------------


def fused_add_plain(a, b, group=G1):
    return C.merge(group.add(group.split(a), group.split(b)))


def masked_add_and_double_plain(r, t, bits, group=G1):
    added = group.add(group.split(r), group.split(t))
    res = group.select(bits != 0, added, group.split(r))
    return C.merge(res), C.merge(group.double(group.split(t)))


def fused_running_add_plain(m, g, b, group=G1):
    m2 = group.add(group.split(m), group.split(b))
    g2 = group.add(group.split(g), m2)
    return C.merge(m2), C.merge(g2)


def fused_add(a, b, group=G1):
    """Canonical complete add of every lane: the JAX package's fused_add
    (one level of its tree sum), for holding the port against it on the
    CPU.  The card has no kernel for one level: the naive engine's tree
    sum runs every level in one launch (tree_sum), so CUDA tensors
    raise."""
    n = check_plane(a, group.rows)
    check_plane(b, group.rows, n)
    if on_cuda(a, b):
        raise ValueError("fused_add has no kernel: on the card tree_sum "
                         "runs every level of the tree sum in one launch")
    return fused_add_plain(a, b, group)


def tree_sum_plain(points, group=G1):
    """Plain form of tree_sum: log2 N levels of fused_add_plain, the JAX
    package's models/naive.py:tree_sum."""
    width = points.shape[1]
    while width > 1:
        half = width // 2
        points = fused_add_plain(points[:, :half], points[:, half:width],
                                 group)
        width = half
    return points


def tree_sum(points, group=G1):
    """The lanes of a canonical (39|36, N) plane folded into one, (39|36,
    1), in one launch: the JAX package's tree (log2 N levels, lane i +
    lane i + half at each, i < half), so its words.  N a power of two."""
    n = check_plane(points, group.rows)
    if n < 1 or n & (n - 1):
        raise ValueError(f"tree_sum needs a power-of-two width, got {n}")
    if not on_cuda(points):
        return tree_sum_plain(points, group)
    out = torch.empty((group.rows, 1), dtype=torch.int32,
                      device=points.device)
    tag = group.ctx.tag
    # the blocks' partials and their counter: the call's own, zeroed
    words = _lib("canon" + tag).msm_tree_sum_scratch(n)
    scratch = torch.zeros(words, dtype=torch.int32, device=points.device)
    launch("canon" + tag, "msm_tree_sum", "tree_sum" + tag, n,
           points.data_ptr(), scratch.data_ptr(), out.data_ptr(), n,
           device=out.device)
    return out


#: the most bits scalar_mult takes: a scalar's 8 u32 words
SCALAR_BITS = 256


def scalar_mult_plain(table, scalars, bits, group=G1):
    """Plain form of scalar_mult: `bits` steps of
    masked_add_and_double_plain from r = the identity and t = P, bit i of
    the scalar words (least significant first) at step i."""
    n = table.shape[1]
    r = C.merge(group.zero(n, table.device))
    t = C.merge(group.from_affine(group.split_aff(table)))
    for i in range(bits):
        bit = (scalars[i // 32] >> (i % 32)) & 1
        r, t = masked_add_and_double_plain(r, t, bit, group)
    return r


def scalar_mult(table, scalars, bits=SCALAR_BITS, group=G1):
    """k_i * P_i for every lane in one launch: table the canonical
    Montgomery affine plane (G1 (26, N) (x; y), Edwards (27, N) (x; y; t)),
    scalars the (8, N) int32 bits of the u32 words of k_i, least
    significant first; the double-and-add over k_i's low `bits` bits (0 to
    256).  Returns the canonical (39|36, N) plane of r, bit for bit `bits`
    steps of the TPU's masked_add_and_double (r' = bit ? r + t : r, t' =
    2t) from r = the identity and t = P.  One thread a lane, which stops
    after its scalar's top set bit."""
    n = check_plane(table, group.aff_rows)
    check_plane(scalars, SCALAR_BITS // 32, n)
    if not 0 <= bits <= SCALAR_BITS:
        raise ValueError(f"bits must be in [0, {SCALAR_BITS}], got {bits}")
    if not on_cuda(table, scalars):
        return scalar_mult_plain(table, scalars, bits, group)
    out = torch.empty((group.rows, n), dtype=torch.int32, device=table.device)
    tag = group.ctx.tag
    launch("canon" + tag, "msm_scalar_mult", "scalar_mult" + tag, n,
           table.data_ptr(), scalars.data_ptr(), bits, out.data_ptr(), n,
           device=out.device)
    return out


def running_sum_plain(m, g, walk, steps, group=G1):
    """Plain form of running_sum: `steps` fused_running_add_plain steps,
    step t over the walk's columns [t N, (t + 1) N)."""
    n = m.shape[1]
    for t in range(steps):
        m, g = fused_running_add_plain(m, g, walk[:, t * n:(t + 1) * n],
                                       group)
    return m, g


def running_sum(m, g, walk, steps, group=G1):
    """`steps` canonical running-sum steps in one launch: m, g (39|36, N),
    walk (39|36, steps * N) step-major (column t N + j: lane j's addend
    b_t at step t, BPR stage 1's walk order) -> (m, g) after m' = m + b_t,
    g' = g + m' for t = 0 .. steps - 1, the words of `steps` one-step
    launches of the TPU's fused_running_add.  One thread a lane."""
    n = check_plane(m, group.rows)
    check_plane(g, group.rows, n)
    if steps < 1:
        raise ValueError(f"steps must be at least 1, got {steps}")
    check_plane(walk, group.rows, steps * n)
    if not on_cuda(m, g, walk):
        return running_sum_plain(m, g, walk, steps, group)
    m2, g2 = torch.empty_like(m), torch.empty_like(g)
    tag = group.ctx.tag
    launch("canon" + tag, "msm_running_sum", "running_sum" + tag, n,
           m.data_ptr(), g.data_ptr(), walk.data_ptr(), steps, m2.data_ptr(),
           g2.data_ptr(), n, device=m2.device)
    return m2, g2


def fused_running_add(m, g, b, group=G1):
    """One canonical running-sum step, (m + b, g + (m + b)): running_sum
    over one step."""
    return running_sum(m, g, b, 1, group)
