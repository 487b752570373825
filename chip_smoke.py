#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card of capability 9.0, nvcc and g++, and no network. Phases, each
of which raises on failure (so the exit code is not 0):

1. probe: the device, its power limit, torch and nvcc;
2. build: the extension kernel (csrc/extend.cu) with nvcc, timed;
3. kernel against its plain version: a fuzz set (uneven lengths, N runs,
   IUPAC codes, tasks past 10,240 and 12,000 rows) must give identical
   tuples from the kernel, the plain PyTorch version and the native host
   oracle; then both are timed at the main path's shape (512 tasks of
   1,500-3,200 rows, every 8th of 9,900, 12% substitutions);
4. main path: ANIm all-vs-all over 3 synthetic 2 Mb genomes (one
   ancestor at 2%, 8% and 15% substitutions, with indels, N runs and
   IUPAC letters) through the port's runner with the extensions on the
   kernel, rerun with every extension on the native host kernel (the JAX
   package's CPU production path), rows equal; dnadiff on one divergent
   pair the same way.

The last lines are the kernels' JSON record, the card's name and power
limit from nvidia-smi, and the device JSON line.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sqlite3
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

GENOME_LENGTH = 2_000_000  # a small bacterial chromosome
RATES = [0.02, 0.08, 0.15]
SEED = 20261016
KERNEL_SOURCE = "pyani_plus_tpu_torch/csrc/extend.cu"
KERNEL_REPLACES = "pyani_plus_tpu/ops/extend_pallas.py:97"


def phase(name: str) -> float:
    print(f"== {name}", flush=True)
    return time.monotonic()


def done(name: str, t0: float) -> None:
    print(f"   {name} wall seconds: {time.monotonic() - t0:.3f}", flush=True)


def fuzz_tasks(rng: np.random.Generator) -> list[tuple[np.ndarray, np.ndarray]]:
    from pyani_plus_tpu_torch.synthetic import salt

    tasks = []
    # tests/test_dp.py's extension fuzz set
    for _ in range(20):
        m = int(rng.integers(60, 1100))
        n = int(rng.integers(60, 1100))
        a = rng.integers(0, 5, m).astype(np.uint8)
        b = rng.integers(0, 4, n).astype(np.uint8)
        if rng.random() < 0.6:
            span = min(m, n)
            b[:span] = a[:span] % 4
            mut = rng.random(span) < 0.1
            b[:span][mut] = (b[:span][mut] + 1) % 4
        tasks.append((a, b))
    # its oversize case: past the Pallas kernel's largest row bucket
    big = 10240 + 64
    for m, n in ((big, 400), (300, 280), (big + 32, big), (256, 300)):
        a = rng.integers(0, 4, m).astype(np.uint8)
        b = a[: min(m, n)].copy()
        mut = rng.random(b.size) < 0.05
        b[mut] = (b[mut] + 1) % 4
        tasks.append((a, b))
    # ANIm's longest tails (9,999 + 200 rows) and tasks over 12k rows,
    # with N runs and IUPAC letters (codes >= 4)
    for m in (10199, 10199, 12500, 14000):
        a = rng.integers(0, 4, m).astype(np.uint8)
        b = a.copy()
        mut = rng.random(m) < 0.06
        b[mut] = (b[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        a_txt = np.frombuffer(b"ACGT", np.uint8)[a]
        b_txt = np.frombuffer(b"ACGT", np.uint8)[b]
        salt(a_txt, rng, n_runs=2)
        salt(b_txt, rng, n_runs=2)
        tasks.append((encode(a_txt), encode(b_txt)))
    return tasks


def encode(text: np.ndarray) -> np.ndarray:
    """ASCII letters to the packages' codes (A C G T -> 0..3, N -> 4,
    other IUPAC letters -> their ASCII value)."""
    codes = text.copy()
    for code, letter in enumerate(b"ACGTN"):
        codes[text == letter] = code
    return codes


def main_shape_tasks(rng: np.random.Generator) -> list[tuple[np.ndarray, np.ndarray]]:
    tasks = []
    for t in range(512):
        m = int(rng.integers(1500, 3200)) if t % 8 else 9900
        a = rng.integers(0, 4, m).astype(np.uint8)
        b = a.copy()
        mut = rng.random(m) < 0.12
        b[mut] = (b[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        tasks.append((a, b))
    return tasks


def max_abs_err(x: list[tuple], y: list[tuple]) -> int:
    return int(np.abs(np.array(x, np.int64) - np.array(y, np.int64)).max())


def check_kernel(torch, ext) -> dict:
    """Phase 3: the kernel against its plain version and the host oracle."""
    rng = np.random.default_rng(SEED)
    tasks = fuzz_tasks(rng)
    t0 = phase(f"kernel vs plain: fuzz set of {len(tasks)} tasks "
               f"(longest {max(a.size for a, _ in tasks)} rows)")
    got = ext.batch_extend_cuda(tasks)
    torch.cuda.synchronize()
    plain = ext.batch_extend_reference(tasks)
    host = ext.batch_extend_host(tasks, workers=os.cpu_count() or 1)
    if got != plain or got != host:
        bad = [i for i in range(len(tasks)) if not got[i] == plain[i] == host[i]]
        msg = f"kernel disagrees on tasks {bad[:10]}: {[(got[i], plain[i], host[i]) for i in bad[:3]]}"
        raise AssertionError(msg)
    err = max_abs_err(got, plain)
    print(f"   identical tuples: kernel == plain == native on {len(tasks)} tasks")
    done("fuzz", t0)

    tasks = main_shape_tasks(rng)
    t0 = phase("kernel vs plain at the main path's shape: 512 tasks, "
               "1500-3200 rows, every 8th 9900 rows, 12% substitutions")
    packed = [t.cuda() for t in ext.pack_tasks(tasks)]
    out = ext.extend_cuda(*packed)  # warm
    torch.cuda.synchronize()
    reps = 10
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        ext.extend_cuda(*packed)
    stop.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(stop) / reps
    got = [tuple(r) for r in out.cpu().tolist()]

    t1 = time.monotonic()
    ext.batch_extend_cuda(tasks)
    wrapper_ms = (time.monotonic() - t1) * 1e3
    t1 = time.monotonic()
    plain = ext.batch_extend_reference(tasks)
    plain_ms = (time.monotonic() - t1) * 1e3
    workers = os.cpu_count() or 1
    t1 = time.monotonic()
    host = ext.batch_extend_host(tasks, workers=workers)
    host_ms = (time.monotonic() - t1) * 1e3
    if got != plain or got != host:
        raise AssertionError("kernel disagrees with the plain version at the main shape")
    err = max(err, max_abs_err(got, plain))
    print(f"   identical tuples on all 512 tasks; max_abs_err {err}")
    print(f"   kernel ms per launch (CUDA events, mean of {reps}): {kernel_ms:.4f}")
    print(f"   kernel wrapper ms incl. packing and copies (host clock): {wrapper_ms:.3f}")
    print(f"   plain PyTorch ms on the CPU (host clock, one run): {plain_ms:.1f}")
    print(f"   native host kernel ms, {workers} threads (host clock): {host_ms:.1f}")
    done("timing", t0)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms}


def comparison_rows(db: Path) -> list[tuple]:
    with sqlite3.connect(db) as conn:
        return conn.execute(
            "SELECT g1.path, g2.path, c.identity, c.aln_length, c.sim_errors,"
            " c.cov_query, c.cov_subject FROM comparisons c"
            " JOIN genomes g1 ON g1.genome_hash = c.query_hash"
            " JOIN genomes g2 ON g2.genome_hash = c.subject_hash"
            " ORDER BY g1.path, g2.path"
        ).fetchall()


def run_method(ext, runner, logger, work: Path, fasta: Path, method: str,
               tag: str, *, host: bool) -> tuple[list[tuple], int]:
    """One run through the port's runner; returns (rows, kernel launches)."""
    db = work / f"{tag}.db"
    env = "PYANI_TPU_EXTEND_BATCH_MIN"
    if host:  # above every batch: all extensions on the native host kernel
        os.environ[env] = str(1 << 40)
    ext.reset_counts()
    t0 = phase(f"{method} {tag}: {'native host' if host else 'CUDA kernel'} extensions")
    window = ext.devmeter.reset()
    try:
        runner.start_and_run_method(logger, db, fasta, method, create_db=True)
    finally:
        os.environ.pop(env, None)
    launches, tasks = ext.LAUNCHES, ext.TASKS
    busy = ext.devmeter.busy_fraction(window)
    done(tag, t0)
    print(f"   kernel launches {launches}, tasks through the kernel {tasks}")
    print(f"   device busy share (devmeter, submit to sync of each launch): {busy:.4f}")
    return comparison_rows(db), launches


def check_main_path(ext) -> int:
    """Phase 4: ANIm all-vs-all and a dnadiff pair, kernel vs host rows."""
    from pyani_plus_tpu_torch.parallel import runner
    from pyani_plus_tpu_torch.synthetic import write_genome_dir

    logger = logging.getLogger("chip_smoke")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = phase(f"write {len(RATES)} genomes of {GENOME_LENGTH} bp")
        paths = write_genome_dir(work / "genomes", GENOME_LENGTH, RATES, SEED)
        done("genomes", t0)

        rows, launches = run_method(ext, runner, logger, work, work / "genomes",
                                    "ANIm", "anim_kernel", host=False)
        if launches == 0:
            raise AssertionError("the ANIm run never launched the kernel")
        host_rows, host_launches = run_method(ext, runner, logger, work,
                                              work / "genomes", "ANIm",
                                              "anim_host", host=True)
        check_rows("ANIm", rows, host_rows, len(RATES) ** 2)
        if host_launches:
            raise AssertionError("the host run launched the kernel")
        identity = {(Path(q).stem, Path(s).stem): r[0] for q, s, *r in rows}
        for key in sorted(identity):
            print(f"   ANIm identity {key[0]} vs {key[1]}: {identity[key]!r}")
        # more substitutions, lower identity
        if not identity[("genome_0", "genome_1")] > identity[("genome_0", "genome_2")]:
            raise AssertionError("ANIm identities are out of order")

        pair = work / "pair"
        pair.mkdir()
        for path in paths[:2]:
            shutil.copy(path, pair / path.name)
        rows2, launches2 = run_method(ext, runner, logger, work, pair,
                                      "dnadiff", "dnadiff_kernel", host=False)
        host2, _ = run_method(ext, runner, logger, work, pair, "dnadiff",
                              "dnadiff_host", host=True)
        check_rows("dnadiff", rows2, host2, 4)
        if launches2 == 0:
            raise AssertionError("the dnadiff run never launched the kernel")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def check_rows(method: str, rows: list[tuple], host: list[tuple], count: int) -> None:
    if len(rows) != count:
        raise AssertionError(f"{method}: {len(rows)} rows, expected {count}")
    if rows != host:  # integers exact, floats ==
        raise AssertionError(f"{method}: kernel rows differ from host rows")
    for row in rows:
        identity = row[2]
        if identity is None or not 0.5 < identity <= 1.0 or not np.isfinite(identity):
            raise AssertionError(f"{method}: implausible identity in {row}")
    print(f"   {method}: {count} rows, kernel run == host run (ints exact, floats ==)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA H100", file=sys.stderr)
        return 2
    from pyani_plus_tpu_torch import backend
    from pyani_plus_tpu_torch.ops import _build
    from pyani_plus_tpu_torch.ops import extend as ext

    t0 = phase("probe")
    report = backend.probe()
    for line in report.lines():
        print(f"   {line}")
    if not report.kernels_supported:
        raise SystemExit(f"needs capability (9, 0), found {report.capability}")
    if not report.smi:
        raise SystemExit("nvidia-smi gave no name and power limit for the card")
    done("probe", t0)

    t0 = phase("build")
    ext._kernel_library()
    seconds, ptxas = _build.BUILD_INFO["extend"]
    print(f"   nvcc build seconds (set-up): {seconds:.3f}")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"   {line.strip()}")
    done("build", t0)

    timing = check_kernel(torch, ext)
    launches = check_main_path(ext)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    record = {
        "kernels": [
            {
                "name": "extend",
                "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": KERNEL_REPLACES,
                "launches": launches,
                **timing,
            }
        ]
    }
    print(json.dumps(record))
    print(report.smi)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
