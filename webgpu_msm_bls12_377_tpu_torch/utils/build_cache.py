"""Where the port's compiled code goes, and under which key: what the
kernel build (ops/kernels.py, nvcc) and the native oracle's build
(native/, g++) share.

- build_root(): $MSM_BUILD_DIR where it is set, else <repo>/build (listed
  in .gitignore), read at every call.  Each build has a directory of its
  own below it: kernels/, variants/, sass/ and native/.
- toolkit_id(compiler): the compiler's `--version` output, read once a
  process; NO_TOOLKIT where there is no compiler, so that a CPU run keys
  its directories without one.
- key(files, flags, toolkit): sha256 of the files (name and bytes), the
  flags and the toolkit id, cut to 16 hex digits.  A changed source, flag
  or compiler release builds into a new directory and never loads a
  library built from the old one.
- staging(dest) / publish(tmp, dest): a process builds at a name of its
  own and moves the result into place with one rename, so that another
  process building or loading the same file finds a whole one or none.

Importing this module runs no compiler.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterable

ENV = "MSM_BUILD_DIR"
DEFAULT_ROOT = Path(__file__).resolve().parents[2] / "build"
#: the toolkit id where no compiler is found
NO_TOOLKIT = "none"

_toolkits: dict[str, str] = {}
_lock = threading.Lock()


def build_root() -> Path:
    """$MSM_BUILD_DIR, else <repo>/build."""
    return Path(os.environ.get(ENV) or DEFAULT_ROOT)


def toolkit_id(compiler: str | None) -> str:
    """`compiler --version`'s output (NO_TOOLKIT for None), read once a
    process for each compiler; raises where the compiler cannot say its
    version, so that a key never leaves the toolkit out."""
    if compiler is None:
        return NO_TOOLKIT
    with _lock:
        found = _toolkits.get(compiler)
        if found is None:
            out = subprocess.run([compiler, "--version"], capture_output=True,
                                 text=True, timeout=120)
            found = out.stdout.strip()
            if out.returncode or not found:
                raise RuntimeError(
                    f"{compiler} --version failed (exit {out.returncode}): "
                    f"{out.stderr.strip()[-2000:]}")
            _toolkits[compiler] = found
    return found


def key(files: Iterable[Path], flags: Iterable[str], toolkit: str) -> str:
    """16 hex digits of sha256 over the files, the flags and the toolkit
    id."""
    h = hashlib.sha256()
    for f in files:
        f = Path(f)
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(b"\0" + toolkit.encode())
    return h.hexdigest()[:16]


def staging(dest: Path) -> Path:
    """The name this process builds `dest` at before publish."""
    return dest.with_name(f"{dest.name}.tmp{os.getpid()}")


def publish(tmp: Path, dest: Path) -> None:
    """Move a finished build into place with one rename."""
    os.replace(tmp, dest)
