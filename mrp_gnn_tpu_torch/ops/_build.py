"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``ops/_build/`` (git-ignored) and loaded with ``ctypes``. The library file
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is never served by a stale build. Nothing
here runs at import time; a failed build raises, it never falls back to the
plain version. :func:`run` calls a kernel's C entry point.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # name -> nvcc's output (ptxas register use)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or shutil.which(
        "nvcc", path=os.path.join(cuda_home, "bin"))
    if found is None:
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA "
            "kernels cannot be built")
    return found


def _library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names) -> None:
    """Compile every named source that has no current build, one ``nvcc``
    process per source, all started together. Raises RuntimeError with the
    compiler's output if any build fails."""
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        tmp = _library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))


def stream(t) -> int:
    """The current CUDA stream of ``t``'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def run(name: str, argtypes: list, *args, entry: str | None = None) -> None:
    """Call the C entry point ``entry`` (default ``name``) of
    ``csrc/<name>.cu`` (built at first use) and raise if the launch was
    refused."""
    entry = entry or name
    fn = getattr(load(name), entry)  # ctypes keeps one object per name
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {rc}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _libs[name] = lib
        return lib
