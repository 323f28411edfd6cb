"""Build and load the native C++ host helpers (the scene renderer and the
graph-plan builder) from the repository's ``native/<name>.cc``.

Each source is compiled with g++ into ``data/_build/`` (git-ignored), under
a name that carries a hash of the source and the flags, so an edited source
is never served by a stale build and nothing is written beside the source.
The compiler writes to a temporary name that ``os.replace`` moves into
place, so processes that build at the same moment never load a half-written
library.

Before a library is handed out, a tiny smoke call runs in a SUBPROCESS: a
library compiled with ``-march=native`` on another CPU loads fine through
``ctypes.CDLL`` but dies with SIGILL on its first real call, which cannot be
caught in-process. On a failed smoke call the library is deleted and built
once more; if that fails too, :func:`load_verified` returns None. The
verdict is kept in a ``<lib>.ok`` stamp (the library's mtime and a CPU
identity line), so later loads skip the subprocess. :class:`NativeLibrary`
does that once per process, at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Callable

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# Tried in order: the second is the portable fallback.
FLAG_SETS = (("-O3", "-march=native", "-fopenmp"), ("-O3",))


def library_path(name: str) -> Path:
    """Where the build of ``native/<name>.cc`` lives."""
    src = (NATIVE_DIR / f"{name}.cc").read_bytes()
    digest = hashlib.sha256(src + repr(FLAG_SETS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _tmp_name(path: Path) -> Path:
    return path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")


def build(name: str) -> bool:
    """Compile ``native/<name>.cc`` into :func:`library_path`, with the first
    flag set that g++ takes; False when none does."""
    src = NATIVE_DIR / f"{name}.cc"
    lib = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp_name(lib)
    for flags in FLAG_SETS:
        try:
            subprocess.run(["g++", *flags, "-shared", "-fPIC", "-o", str(tmp),
                            str(src)], check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, lib)
        return True
    tmp.unlink(missing_ok=True)
    return False


def _cpu_identity() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            flags = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return hashlib.sha256("".join(flags[:2]).encode()).hexdigest()[:16]
    except OSError:
        return "unknown"


def _stamp_value(lib: Path) -> str:
    return f"{lib.stat().st_mtime:.6f} {_cpu_identity()}"


def _smoke(lib: Path, smoke_code: str) -> bool:
    try:
        r = subprocess.run([sys.executable, "-c", smoke_code, str(lib)],
                           capture_output=True, timeout=60)
        return r.returncode == 0
    except (OSError, subprocess.SubprocessError):
        return False


def load_verified(name: str, smoke_code: str) -> ctypes.CDLL | None:
    """A smoke-checked ``ctypes.CDLL`` of ``native/<name>.cc``, built at
    first use, or None when it cannot be built or does not run here.

    smoke_code: python source run in a subprocess with the library's path
    as ``sys.argv[1]``; it must exit 0 iff a real call succeeds.
    """
    # GOMP's default ACTIVE wait policy spin-waits at barriers; with as many
    # OpenMP threads as cores plus a busy Python main thread, a 2 ms parallel
    # region was measured at 32 ms (15x) on a 2-core host. Passive waiting
    # costs a wakeup, which is noise at these region sizes.
    os.environ.setdefault("OMP_WAIT_POLICY", "passive")
    lib = library_path(name)
    fresh = False
    if not lib.exists():
        if not build(name):
            return None
        fresh = True
    stamp = lib.with_name(lib.name + ".ok")
    verified = False
    if not fresh:
        try:
            verified = stamp.read_text().strip() == _stamp_value(lib)
        except OSError:
            verified = False
    if not verified:
        if not _smoke(lib, smoke_code):
            # A foreign or stale binary: build from source once more.
            lib.unlink(missing_ok=True)
            if not (build(name) and _smoke(lib, smoke_code)):
                return None
        try:
            tmp = _tmp_name(stamp)
            tmp.write_text(_stamp_value(lib))
            os.replace(tmp, stamp)
        except OSError:
            pass
    try:
        return ctypes.CDLL(str(lib))
    except OSError:
        return None


class NativeLibrary:
    """``native/<name>.cc``, loaded with :func:`load_verified` at the first
    :meth:`get` and kept for the process; ``configure`` declares the
    entry points' ctypes signatures on the loaded library."""

    def __init__(self, name: str, smoke_code: str,
                 configure: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.smoke_code = smoke_code
        self.configure = configure
        self._lock = threading.Lock()
        self._lib = None
        self._failed = False

    def get(self) -> ctypes.CDLL | None:
        """The configured library, or None when it cannot be built or does
        not run here (decided once)."""
        with self._lock:
            if self._lib is None and not self._failed:
                lib = load_verified(self.name, self.smoke_code)
                if lib is None:
                    self._failed = True
                else:
                    self.configure(lib)
                    self._lib = lib
            return self._lib
