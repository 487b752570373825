#!/usr/bin/env python3
"""Time variants of the extension kernel side by side on one card.

Usage, from the root of a checkout on a machine with an H100 and nvcc:

    python3 tools/extend_variants.py SOURCE.cu[:-DFLAG[:-DFLAG...]] ...

Each argument is a CUDA source with ``csrc/extend.cu``'s C interface
(``extend_launch``), optionally followed by compiler flags. Every variant
is built with the package's nvcc flags, run on chip_smoke.py's fuzz set
and main shape (512 tasks, every 8th of 9,900 rows), compared with the
native host oracle, and timed over 10 launches with CUDA events, twice
round robin, so that all variants meet the same card in the same call.
The tree keeps one kernel; candidates live in a directory that is not
versioned while they are tried.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from pyani_plus_tpu_torch import backend  # noqa: E402
from pyani_plus_tpu_torch.ops import _build  # noqa: E402
from pyani_plus_tpu_torch.ops import extend as ext  # noqa: E402
from pyani_plus_tpu_torch.ops.extend_host import EXTEND, MATCH, MISMATCH, OPEN  # noqa: E402


def build(spec: str, out_dir: Path) -> ctypes.CDLL | None:
    src, *flags = spec.split(":")
    so = out_dir / (spec.replace("/", "_").replace(":", "_") + ".so")
    t0 = time.monotonic()
    cmd = [backend.nvcc_path() or "nvcc", *_build.NVCC_FLAGS, *flags, "-o", str(so), src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(f"{spec}: build {time.monotonic() - t0:.1f} s, exit {proc.returncode}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"   {line.strip()}")
    if proc.returncode:
        return None
    lib = ctypes.CDLL(str(so))
    lib.extend_launch.restype = ctypes.c_int
    lib.extend_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    return lib


def run(lib: ctypes.CDLL, tasks: list, reps: int = 0) -> tuple[list[tuple], float | None]:
    staging, order = ext.pack_tasks(tasks)
    packed = ext.split_packed(staging.cuda(), len(tasks))
    out = torch.empty((len(tasks), 5), dtype=torch.int32, device="cuda")

    def launch() -> None:
        rc = lib.extend_launch(
            *(t.data_ptr() for t in packed), len(tasks), ext.STOP_ROWS,
            MATCH, MISMATCH, OPEN, EXTEND, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )  # fmt: skip
        if rc:
            raise RuntimeError(f"launch refused: {rc}")

    launch()
    torch.cuda.synchronize()
    rows = np.empty((len(tasks), 5), np.int32)
    rows[order] = out.cpu().numpy()
    ms = None
    if reps:
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            launch()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / reps
    return [tuple(r) for r in rows.tolist()], ms


def main() -> int:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    rng = np.random.default_rng(chip_smoke.SEED)
    fuzz = chip_smoke.fuzz_tasks(rng)
    tasks = chip_smoke.main_shape_tasks(rng)
    host_fuzz = ext.batch_extend_host(fuzz, workers=8)
    host_main = ext.batch_extend_host(tasks, workers=8)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {spec: build(spec, Path(tmp)) for spec in sys.argv[1:]}
        for rnd in range(2):
            for spec, lib in libs.items():
                if lib is None:
                    continue
                got, _ = run(lib, fuzz)
                bad = [i for i, row in enumerate(got) if row != host_fuzz[i]]
                got_main, ms = run(lib, tasks, reps=10)
                bad_main = [i for i, row in enumerate(got_main) if row != host_main[i]]
                print(f"round {rnd} {spec}: main shape {ms:.4f} ms; tasks that differ from the "
                      f"oracle: fuzz {bad[:5]}, main shape {bad_main[:5]}")
    print(backend.probe().smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
