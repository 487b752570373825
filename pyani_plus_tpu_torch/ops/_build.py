"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface; nvcc compiles it
for sm_90a into a shared library under ``pyani_plus_tpu_torch/_build/``
(not versioned), which ctypes loads. The library's file name carries a
hash of the source, so an edited source is rebuilt and a stale library
is never loaded. A build failure raises with nvcc's own error output:
nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

from pyani_plus_tpu_torch import backend

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

# One lock per library: pair threads call in from a pool, and different
# libraries build at the same time (one nvcc each).
_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# name -> (build seconds, 0.0 when the library was already built;
# ptxas report of registers, shared memory and spills)
BUILD_INFO: dict[str, tuple[float, str]] = {}


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        so = library_path(name)
        if so.is_file():
            BUILD_INFO[name] = (0.0, "")
        else:
            BUILD_INFO[name] = _compile(CSRC_DIR / f"{name}.cu", so)
        lib = ctypes.CDLL(str(so))
        _LIBS[name] = lib
        return lib


def _compile(src: Path, so: Path) -> tuple[float, str]:
    nvcc = backend.nvcc_path()
    if nvcc is None:
        msg = f"cannot build {src.name}: nvcc not found (set CUDA_HOME)"
        raise RuntimeError(msg)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a private name and rename, so that another process never
    # loads a half-written library.
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        msg = f"nvcc failed on {src.name} ({' '.join(cmd)}):\n{proc.stderr}"
        raise RuntimeError(msg)
    os.replace(tmp, so)
    return seconds, proc.stderr
