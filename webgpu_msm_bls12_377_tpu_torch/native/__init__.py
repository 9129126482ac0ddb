"""The native C++ MSM oracle: an independent host Pippenger that checks a
sum of points handed to it (msm_oracle.cpp: 6 x 64-bit CIOS Montgomery
limbs, an unsigned window of 13, a thread a window).

Built at first use: gen_params.py writes params_generated.h from the
port's params.py, and g++ compiles msm_oracle.cpp against it, both into
<build_root()>/native/<key>/ (utils/build_cache.py: the key hashes the
.cpp, gen_params.py, params.py, the flags and g++'s --version), each
file published with one rename, so that processes building at once all
load a whole library.  Nothing is written beside these sources.  The
library is loaded with ctypes.  Importing this module builds nothing.

    from webgpu_msm_bls12_377_tpu_torch import native
    x, y = native.msm_g1(points_buf, scalars_buf)   # wire-format bytes
    x, y = native.msm_g1_ints(affine_pairs, scalar_ints)

available() is False only where g++ is missing or the build fails; the
MSM functions then raise Unavailable.  A coordinate that is not below p
raises ValueError.  Imports neither torch nor JAX.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils import build_cache
from . import gen_params

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "msm_oracle.cpp"
FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")
LIBRARY = "libmsm_oracle.so"

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


class Unavailable(RuntimeError):
    """g++ is missing, or the oracle does not build."""


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise Unavailable("g++ not found: the native oracle cannot be built")
    return found


def build_dir() -> Path:
    """<build_root()>/native/<key>: where the header and the library go
    (g++'s --version is read here, so g++ must be present)."""
    files = (SOURCE, Path(gen_params.__file__), _DIR.parent / "params.py")
    key = build_cache.key(files, FLAGS,
                          build_cache.toolkit_id(_compiler()))
    return build_cache.build_root() / "native" / key


def build() -> Path:
    """The library's path, built first where it is not there yet."""
    out_dir = build_dir()
    lib = out_dir / LIBRARY
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    gen_params.generate(out_dir)
    tmp = build_cache.staging(lib)
    out = subprocess.run([_compiler(), *FLAGS, f"-I{out_dir}", "-o", str(tmp),
                          str(SOURCE)], capture_output=True, text=True)
    if out.returncode:
        tmp.unlink(missing_ok=True)
        raise Unavailable(f"the native oracle does not build:\n{out.stderr}")
    build_cache.publish(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn in (lib.msm_g1, lib.msm_edwards):
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_size_t, ctypes.c_char_p]
            _lib = lib
    return _lib


def available() -> bool:
    """True where the oracle is built and loaded (building it now if need
    be); False only where g++ is missing or the build fails."""
    try:
        _load()
    except Unavailable:
        return False
    return True


def _msm(fn: str, coord_bytes: int, points_buf: bytes,
         scalars_buf: bytes) -> tuple[int, int]:
    n, rest = divmod(len(scalars_buf), 32)
    if rest or len(points_buf) != 2 * coord_bytes * n:
        raise ValueError(f"{fn}: {len(points_buf)} point bytes and "
                         f"{len(scalars_buf)} scalar bytes are not n points "
                         f"of {2 * coord_bytes} bytes and n scalars of 32")
    out = ctypes.create_string_buffer(2 * coord_bytes)
    if getattr(_load(), fn)(bytes(points_buf), bytes(scalars_buf), n, out):
        raise ValueError(f"{fn}: a coordinate is not below p")
    raw = out.raw
    return (int.from_bytes(raw[:coord_bytes], "little"),
            int.from_bytes(raw[coord_bytes:], "little"))


def msm_g1(points_buf: bytes, scalars_buf: bytes) -> tuple[int, int]:
    """BLS12-377 G1 MSM over wire-format buffers (x||y, 48 bytes each, a
    point; 32-byte scalars); the affine (x, y), the identity as (0, 1)."""
    return _msm("msm_g1", 48, points_buf, scalars_buf)


def msm_edwards(points_buf: bytes, scalars_buf: bytes) -> tuple[int, int]:
    """Twisted Edwards BLS12 MSM over wire-format buffers (32-byte
    coordinates); the affine (x, y)."""
    return _msm("msm_edwards", 32, points_buf, scalars_buf)


def _pack(vals, nbytes: int) -> bytes:
    return b"".join(int(v).to_bytes(nbytes, "little") for v in vals)


def msm_g1_ints(points, scalars) -> tuple[int, int]:
    """msm_g1 over affine (x, y) int pairs and int scalars."""
    return msm_g1(b"".join(_pack(p, 48) for p in points), _pack(scalars, 32))


def msm_edwards_ints(points, scalars) -> tuple[int, int]:
    """msm_edwards over affine (x, y) int pairs and int scalars."""
    return msm_edwards(b"".join(_pack(p, 32) for p in points),
                       _pack(scalars, 32))
