#!/usr/bin/env python3
"""Time variants of the Smith-Waterman kernel side by side on one card.

Usage, from the root of a checkout on a machine with an H100 and nvcc:

    python3 tools/sw_variants.py [--sass DIR] SOURCE.cu[:wide] ...

Each argument is a CUDA source with ``csrc/sw.cu``'s C interface
(``sw_launch``). Every variant is built with the package's nvcc flags
(its registers, spills and shared memory are printed), run on
chip_smoke.py's fuzz set and on ANIb's shape (1,024 tasks), compared
with the native host oracle, and timed with CUDA events, twice round
robin, so that all variants meet the same card in the same call: 1,024
tasks (mean of 10 launches), and the mix 32 times over, shuffled, in one
launch (32,768 tasks, mean of 3). ``SOURCE.cu:wide`` builds a copy of the
source whose width rule sends every task down the 32-bit path, which
checks and times that path on tasks that the rule would give to the
packed lanes. ``--sass DIR`` writes each variant's disassembly
(cuobjdump) there. The tree keeps one kernel; candidates live in a
directory that is not versioned while they are tried.
"""

from __future__ import annotations

import ctypes
import os
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
from pyani_plus_tpu_torch.ops import sw  # noqa: E402

BIG = 32  # the large batch: the main-shape mix this many times
RULE = "const bool packed ="  # csrc/sw.cu's width rule begins so


def build(spec: str, out_dir: Path, sass_dir: Path | None) -> ctypes.CDLL | None:
    src, _, mode = spec.partition(":")
    name = spec.replace("/", "_").replace(":", "_")
    so = out_dir / f"{name}.so"
    if mode == "wide":  # the same source with its width rule switched off
        text = Path(src).read_text()
        if text.count(RULE) != 1:
            raise SystemExit(f"{src}: no width rule to switch off ({RULE!r})")
        src = str(out_dir / f"{name}.cu")
        Path(src).write_text(text.replace(RULE, RULE + " false &&"))
    elif mode:
        raise SystemExit(f"{spec}: the only mode is 'wide'")
    t0 = time.monotonic()
    cmd = [backend.nvcc_path() or "nvcc", *_build.NVCC_FLAGS, "-o", str(so), src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(f"{spec}: build {time.monotonic() - t0:.1f} s, exit {proc.returncode}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line or "smem" in line or "error" in line:
            print(f"   {line.strip()}")
    if proc.returncode:
        return None
    if sass_dir is not None:
        sass_dir.mkdir(parents=True, exist_ok=True)
        dump = subprocess.run(["cuobjdump", "-sass", str(so)], capture_output=True, text=True)
        (sass_dir / f"{name}.sass").write_text(dump.stdout or dump.stderr)
    lib = ctypes.CDLL(str(so))
    lib.sw_launch.restype = ctypes.c_int
    lib.sw_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    return lib


def run(lib: ctypes.CDLL, packed: list[torch.Tensor], *,
        reps: int = 0) -> tuple[list[tuple], float | None]:
    nb = packed[4].numel()
    out = torch.empty((nb, 3), dtype=torch.int32, device="cuda")
    scratch = torch.empty((packed[0].numel(), 2), dtype=torch.int32, device="cuda")

    def launch() -> None:
        rc = lib.sw_launch(
            *(t.data_ptr() for t in packed), nb, scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )  # fmt: skip
        if rc:
            raise RuntimeError(f"launch refused: {rc}")

    launch()
    torch.cuda.synchronize()
    rows = [tuple(r) for r in out.cpu().tolist()]
    ms = None
    if reps:
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            launch()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / reps
    return rows, ms


def differing(got: list[tuple], want: list[tuple]) -> list[int]:
    return [i for i, row in enumerate(got) if row != want[i]][:5]


def main() -> int:
    args = sys.argv[1:]
    sass_dir = None
    if args[:1] == ["--sass"]:
        sass_dir, args = Path(args[1]), args[2:]
    if not args or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    fuzz = chip_smoke.sw_fuzz_tasks(rng)
    tasks = chip_smoke.sw_main_tasks(rng)
    workers = os.cpu_count() or 1
    host_fuzz = sw.batch_sw_best_host(fuzz, workers=workers)
    host_main = sw.batch_sw_best_host(tasks, workers=workers)
    narrow = sum(sw.uses_packed_lanes(q.size, s.size) for q, s in fuzz)
    cells = sum(q.size * s.size for q, s in tasks)
    print(f"fuzz set: {len(fuzz)} tasks, {narrow} in packed lanes; main shape: "
          f"{len(tasks)} tasks, {cells} cells; large batch: {BIG * len(tasks)} tasks")
    order = np.random.default_rng(chip_smoke.SEED + 5).permutation(BIG * len(tasks)) % len(tasks)
    big = [tasks[t] for t in order]
    host_big = [host_main[t] for t in order]
    on_card = {name: [t.cuda() for t in sw.pack_tasks(batch)]
               for name, batch in (("fuzz", fuzz), ("main", tasks), ("big", big))}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {spec: build(spec, Path(tmp), sass_dir) for spec in args}
        for rnd in range(2):
            for spec, lib in libs.items():
                if lib is None:
                    continue
                bad = {"fuzz": differing(run(lib, on_card["fuzz"])[0], host_fuzz)}
                got, ms = run(lib, on_card["main"], reps=10)
                bad["main"] = differing(got, host_main)
                got, big_ms = run(lib, on_card["big"], reps=3)
                bad["large batch"] = differing(got, host_big)
                print(f"round {rnd} {spec}: main shape {ms:.4f} ms "
                      f"({cells / ms / 1e6:.1f} G cells/s), "
                      f"large batch {big_ms:.4f} ms ({BIG * cells / big_ms / 1e6:.1f} G cells/s); "
                      f"tasks that differ from the oracle: "
                      f"{ {k: v for k, v in bad.items() if v} or 'none'}")
    print(backend.probe().smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
