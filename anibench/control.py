"""The control of each cell's comparison: the reference put in the
program's place and computed one precision lower (float32 where the
rows are float64), judged by the same numbers as a run.

    python -m anibench.control --workload <cell> --seeds <n>,<n>,...

prints, for each seed, the numbers against the cell's limits; the
control has to come out as not correct on every seed. PERF.md gives the
readings the limits were set from. The benchmark's own runs do not run
it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def control(name: str, seed: int, device: str, overrides: dict | None = None) -> dict:
    from anibench import gen, judge
    from anibench.run import cell, collection_of, reference_md5

    _bench, workload, config = cell(name)
    collection = collection_of(workload, config, overrides)
    n = collection["clades"] * collection["per_clade"]
    work = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "anibench-control" / name
    shutil.rmtree(work, ignore_errors=True)
    try:
        paths = gen.write_collection(collection, seed, work)
        pairs = [(q, s) for q in range(n) for s in range(n)]
        reference = importlib.import_module(f"anibench.reference.{config['method'].lower()}")
        t0 = time.perf_counter()
        state = reference.prepare(paths, pairs, device, config["params"])
        md5 = [reference_md5(p) for p in paths]
        want = {(md5[q], md5[s]): row for (q, s), row in reference.rows(state, np.float64).items()}
        lower = {(md5[q], md5[s]): row for (q, s), row in reference.rows(state, np.float32).items()}
        numbers, failed = judge.compare(lower, want, config["fields"], config["limits"])
        numbers["missing_rows"] = float(len(set(want) - set(lower)))
        return {
            "workload": name,
            "seed": seed,
            "correct": judge.verdict(numbers, config["limits"]),
            "failed": failed,
            "pairs": len(pairs),
            "numbers": numbers,
            "limits": config["limits"],
            "seconds": time.perf_counter() - t0,
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m anibench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("anibench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control(args.workload, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
