"""Build the package's compiled code at first use and load it.

Two kinds of source, one discipline:

- ``csrc/<name>.cu``: a hand-written CUDA kernel with a plain C
  interface, compiled by nvcc for sm_90a (``load_library``). A build
  failure raises with nvcc's own error output: nothing falls back to
  another path.
- ``native/<name>.cpp``: a C++ host kernel, compiled by g++
  (``load_host_library``). Without a compiler there is no native
  library: the loader returns ``None`` (logged at DEBUG) and the caller
  takes its numpy route.

Both go into ``pyani_plus_tpu_torch/_build/`` (not versioned) and are
loaded with ctypes. The library's file name carries a hash of the source
(for host code also of the CPU it was tuned for), so an edited source is
rebuilt and a stale library is never loaded. The compiler writes to a
private name that is renamed into place, so another process never loads
a half-written file, and one lock per library is held across build and
load, so a thread that asks while another builds waits for the library
instead of being told there is none.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

from pyani_plus_tpu_torch import backend

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
NATIVE_DIR = PACKAGE_DIR / "native"
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
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# Codegen tuned to the building CPU, tried first; the portable flags
# follow when the toolchain rejects it.
GXX_TUNED = ["-march=native", "-funroll-loops"]

# One lock per library: pair threads call in from a pool, and different
# libraries build at the same time (one compiler process each).
_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}
# name -> (build seconds, 0.0 when the library was already built;
# the compiler's report: for nvcc, ptxas on registers, shared memory and
# spills)
BUILD_INFO: dict[str, tuple[float, str]] = {}


def _lock_for(key: str) -> threading.Lock:
    with _LOCKS_LOCK:
        return _LOCKS.setdefault(key, threading.Lock())


def _cpu_tag() -> str:
    """What ``-march=native`` was tuned for: a library built on one CPU
    must not be loaded on another (a copied build directory)."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("flags"):
                return line
    except OSError:
        pass
    return platform.machine()


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def host_library_path(name: str) -> Path:
    digest = hashlib.sha256((NATIVE_DIR / f"{name}.cpp").read_bytes())
    digest.update(_cpu_tag().encode())
    return BUILD_DIR / f"lib{name}-host-{digest.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library."""
    with _lock_for(name):
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        so = library_path(name)
        if so.is_file():
            BUILD_INFO[name] = (0.0, "")
        else:
            BUILD_INFO[name] = _compile_cuda(CSRC_DIR / f"{name}.cu", so)
        lib = ctypes.CDLL(str(so))
        _LIBS[name] = lib
        return lib


def load_host_library(name: str) -> ctypes.CDLL | None:
    """Build ``native/<name>.cpp`` if needed and return the loaded
    library, or ``None`` when it cannot be built (no g++)."""
    key = f"host:{name}"
    with _lock_for(key):
        if key in _LIBS:
            return _LIBS[key]
        lib = None
        try:
            so = host_library_path(name)
            if so.is_file():
                BUILD_INFO[key] = (0.0, "")
            else:
                BUILD_INFO[key] = _compile_host(NATIVE_DIR / f"{name}.cpp", so)
            lib = ctypes.CDLL(str(so))
        except (OSError, RuntimeError) as exc:
            logging.getLogger(__package__).debug(
                "native %s unavailable: %s", name, exc
            )
        _LIBS[key] = lib
        return lib


def _run_to(so: Path, commands: list[list[str]], what: str) -> tuple[float, str]:
    """Run the first command that succeeds, each writing ``so`` under a
    private name (the last argument), then rename into place."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.monotonic()
    errors = []
    for cmd in commands:
        try:
            proc = subprocess.run([*cmd, str(tmp)], capture_output=True, text=True)
        except OSError as exc:
            errors.append(f"{' '.join(cmd)}: {exc}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, so)
            return time.monotonic() - t0, proc.stderr
        tmp.unlink(missing_ok=True)
        errors.append(f"{' '.join(cmd)}:\n{proc.stderr}")
    msg = f"{what} failed:\n" + "\n".join(errors)
    raise RuntimeError(msg)


def _compile_cuda(src: Path, so: Path) -> tuple[float, str]:
    nvcc = backend.nvcc_path()
    if nvcc is None:
        msg = f"cannot build {src.name}: nvcc not found (set CUDA_HOME)"
        raise RuntimeError(msg)
    return _run_to(so, [[nvcc, *NVCC_FLAGS, str(src), "-o"]], f"nvcc on {src.name}")


def _compile_host(src: Path, so: Path) -> tuple[float, str]:
    gxx = shutil.which("g++")
    if gxx is None:
        msg = f"cannot build {src.name}: g++ not found"
        raise RuntimeError(msg)
    tuned = [gxx, GXX_FLAGS[0], *GXX_TUNED, *GXX_FLAGS[1:], str(src), "-o"]
    portable = [gxx, *GXX_FLAGS, str(src), "-o"]
    return _run_to(so, [tuned, portable], f"g++ on {src.name}")
