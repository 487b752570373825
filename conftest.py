"""Ask the PyTorch port for the CPU, and build the JAX package's native
libraries, before any test file is collected.

The port runs every compute path on the card unless the caller asks for
the CPU with ``PYANI_TPU_TORCH_DEVICE=cpu``; without a card and without
that request it refuses. The tests compare the port with the JAX package
on the CPU, so the session asks for the CPU here, once, for every test and
every subprocess it starts (a caller's own choice is kept). A test that
needs the card asks for it with
``monkeypatch.setenv("PYANI_TPU_TORCH_DEVICE", "cuda")``.

The loaders of ``pyani_plus_tpu/native`` build ``lib*.so`` in place at
first use and give up for the whole process after one failed load. Under
pytest-xdist a worker that loads a library another worker is still
writing gets nothing, and the test files whose ``skipif`` asks for a
loader while they are collected then skip. pytest loads this file before
``tests/conftest.py`` and before collecting any test file: once in the
xdist controller before any worker starts, and again in each worker,
where every library is then up to date and nothing is rebuilt. The builds
run under one ``fcntl`` lock in the temporary directory, so that pytest
processes started side by side take turns. Without g++ this does nothing
and the loaders behave as they always did.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def _build_native_libraries() -> None:
    if not shutil.which("g++"):
        return
    import pyani_plus_tpu.native as native  # its loaders import no JAX

    def build(source: Path) -> None:
        try:
            native._build(source, source.with_name(f"lib{source.stem}.so"))
        except (subprocess.CalledProcessError, OSError):
            pass  # the loader meets the same failure and reports it

    sources = sorted(Path(native.__file__).parent.glob("*.cpp"))
    with (Path(tempfile.gettempdir()) / "pyani_plus_tpu_native_build.lock").open("a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        with ThreadPoolExecutor(max_workers=len(sources) or 1) as pool:
            list(pool.map(build, sources))


os.environ.setdefault("PYANI_TPU_TORCH_DEVICE", "cpu")
_build_native_libraries()
