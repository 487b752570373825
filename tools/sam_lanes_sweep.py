"""Time ANIm's matching-statistics stream through a subject's suffix
automaton: the serial ``sam_stream_ms`` against ``sam_stream_ms_lanes`` at
each lane cap given, on the shapes of ``anim_bact4.strains``.

    python3 tools/sam_lanes_sweep.py [--length 2500000] [--rate 0.003] CAP [CAP ...]

Each cap is a copy of ``native/suffix.cpp`` with ``MS_LANES_MAX`` set to it,
built with the package's g++ flags into a temporary directory. Four random
genomes of ``--length`` bases are indexed; each query is a copy of its
subject at ``--rate`` substitutions, as a strain of it. Timed, each the median of three, every
output checked equal to the serial stream's:

- ``minus``, ``plus``, ``self``: one stream alone (the reverse complement,
  the strand itself, the subject against itself);
- ``minus_x8``: eight minus strands at once on eight threads (wall);
- ``both_x16``: eight plus and eight minus strands at once on sixteen
  threads, as ANIm's eight pair threads run them (wall).

One JSON line a cap, after a line naming the host's CPU and the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pyani_plus_tpu_torch.genomes import complement_codes  # noqa: E402
from pyani_plus_tpu_torch.ops._build import GXX_FLAGS, GXX_TUNED  # noqa: E402

SOURCE = ROOT / "pyani_plus_tpu_torch" / "native" / "suffix.cpp"
CAP_LINE = "constexpr int MS_LANES_MAX = 16;"
U8, I32, I64 = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_int32, ctypes.c_int64))


def build(cap: int, work: Path) -> ctypes.CDLL:
    text = SOURCE.read_text()
    assert CAP_LINE in text, "MS_LANES_MAX is no longer where this tool sets it"
    src = work / f"suffix_{cap}.cpp"
    src.write_text(text.replace(CAP_LINE, f"constexpr int MS_LANES_MAX = {cap};"))
    out = work / f"libsuffix_{cap}.so"
    subprocess.run(["g++", *GXX_FLAGS, *GXX_TUNED, str(src), "-o", str(out)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.sam_build.restype = ctypes.c_void_p
    lib.sam_build.argtypes = [U8, ctypes.c_int64]
    lib.sam_free.argtypes = [ctypes.c_void_p]
    lib.sam_ms_lanes.restype = ctypes.c_int32
    lib.sam_ms_lanes.argtypes = [ctypes.c_int64]
    for name in ("sam_stream_ms", "sam_stream_ms_lanes"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, U8, ctypes.c_int64, I32, I64]
    lib.sam_stream_ms.restype = None
    lib.sam_stream_ms_lanes.restype = ctypes.c_int64
    return lib


def stream(lib, fn: str, handle, qry: np.ndarray):
    ms_len = np.empty(qry.size, np.int32)
    ref_start = np.empty(qry.size, np.int64)
    getattr(lib, fn)(ctypes.c_void_p(handle), qry.ctypes.data_as(U8), qry.size,
                     ms_len.ctypes.data_as(I32), ref_start.ctypes.data_as(I64))  # fmt: skip
    return ms_len, ref_start


def timed(run, jobs):
    walls = []
    for _ in range(3):
        with ThreadPoolExecutor(len(jobs)) as pool:
            start = time.perf_counter()
            outs = list(pool.map(run, jobs))
            walls.append(time.perf_counter() - start)
    return statistics.median(walls), outs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("caps", nargs="+", type=int)
    parser.add_argument("--length", type=int, default=2_500_000)
    parser.add_argument("--rate", type=float, default=0.003)
    args = parser.parse_args()
    rng = np.random.default_rng(2026)
    refs = [rng.integers(0, 4, args.length).astype(np.uint8) for _ in range(4)]
    plus = []
    for k in range(4):
        qry = refs[k].copy()
        mut = rng.random(qry.size) < args.rate
        qry[mut] = (qry[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        plus.append(qry)
    minus = [complement_codes(q)[::-1].copy() for q in plus]
    card = shutil.which("nvidia-smi") and subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()  # fmt: skip
    cpu = next((line.split(":", 1)[1].strip() for line in Path("/proc/cpuinfo").read_text().splitlines()
                if line.startswith("model name")), "")  # fmt: skip
    print(json.dumps({"cpu": cpu, "cores": os.cpu_count(), "card": card or None}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for cap in args.caps:
            lib = build(cap, Path(tmp))
            handles = [lib.sam_build(r.ctypes.data_as(U8), r.size) for r in refs]
            shapes = {
                "minus": [(0, minus[0])],
                "plus": [(0, plus[0])],
                "self": [(1, refs[1])],
                "minus_x8": [(k % 4, minus[k % 4]) for k in range(8)],
                "both_x16": [(k % 4, q[k % 4]) for k in range(8) for q in (plus, minus)],
            }
            row = {"cap": cap, "lanes": int(lib.sam_ms_lanes(args.length))}
            for shape, jobs in shapes.items():
                serial_s, serial = timed(lambda job: stream(lib, "sam_stream_ms", handles[job[0]], job[1]), jobs)
                lanes_s, lanes = timed(lambda job: stream(lib, "sam_stream_ms_lanes", handles[job[0]], job[1]), jobs)
                for a, b in zip(serial, lanes):
                    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]), (cap, shape)
                row[shape] = {"serial_s": round(serial_s, 4), "lanes_s": round(lanes_s, 4),
                              "speedup": round(serial_s / lanes_s, 2)}  # fmt: skip
            for handle in handles:
                lib.sam_free(handle)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
