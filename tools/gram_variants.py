#!/usr/bin/env python3
"""Time the sourmash Gram of this checkout against another checkout's on one card.

Usage, from the root of a checkout on a machine with a CUDA card:

    python3 tools/gram_variants.py OTHER_CHECKOUT [--pairs 10]

Both ``ops/minhash.gram`` functions get the same indices on the card:
chip_smoke.py's Gram at scale (1,000 sketches in 40 clades, blocks of
4,096 ids). Each call is timed with CUDA events from the indices on the
card to the int64 counts on the host, in pairs whose order alternates,
so that both meet the same card in the same call. The counts must equal
each other and scipy's. The other checkout's module is loaded from its
file; what it imports comes from this checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from pyani_plus_tpu_torch.ops import minhash  # noqa: E402
from pyani_plus_tpu_torch.synthetic import clade_sketches  # noqa: E402

BLOCK = 4096


def load_other(checkout: Path):
    """The other checkout's ``ops/minhash.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        "other_minhash", checkout / "pyani_plus_tpu_torch" / "ops" / "minhash.py"
    )
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look themselves up there
    spec.loader.exec_module(module)
    return module


def counts(module, pts: torch.Tensor, n: int) -> np.ndarray:
    """The int64 counts on the host, whether ``gram`` returns them there
    or as a float64 tensor on the card."""
    out = module.gram(pts, n, BLOCK)
    return out.to(torch.int64).cpu().numpy() if isinstance(out, torch.Tensor) else out


def timed_ms(module, pts: torch.Tensor, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    counts(module, pts, n)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--pairs", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gram_variants: no CUDA device", file=sys.stderr)
        return 2
    other = load_other(args.other)
    sketches = clade_sketches(chip_smoke.SEED + 3, 1000, 40)
    n = len(sketches)
    pts_host = minhash.incidence(sketches, BLOCK)
    if not np.array_equal(pts_host, other.incidence(sketches, BLOCK)):
        raise AssertionError("the two checkouts build different indices")
    pts = torch.from_numpy(pts_host).cuda()
    variants = {"this": minhash, "other": other}
    expected = minhash.intersection_matrix_host(sketches)
    for name, module in variants.items():
        if not np.array_equal(counts(module, pts, n), expected):
            raise AssertionError(f"{name}'s counts differ from scipy's")
    times: dict[str, list[float]] = {name: [] for name in variants}
    for i in range(args.pairs):
        order = list(variants) if i % 2 == 0 else list(reversed(variants))
        for name in order:
            times[name].append(timed_ms(variants[name], pts, n))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    print(f"{n} sketches, {sum(s.num_hashes for s in sketches)} hashes, "
          f"{pts_host.shape[0]} blocks; counts equal (this == other == scipy); {smi}")
    for name, values in times.items():
        q1, median, q3 = np.percentile(values, [25, 50, 75])
        print(f"{name} ({variants[name].__file__}): ms median {median:.3f}, quartiles "
              f"{q1:.3f}-{q3:.3f}, all {[round(v, 3) for v in values]}")
    wins = sum(a < b for a, b in zip(times["this"], times["other"]))
    print(f"this checkout faster in {wins} of {args.pairs} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
