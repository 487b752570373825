#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card of capability 9.0, nvcc and g++, and no network. Phases, each
of which raises on failure (so the exit code is not 0):

1. probe: the device, its power limit, torch and nvcc;
2. build: both kernels (csrc/extend.cu, csrc/sw.cu), one nvcc each, all
   started together, timed;
3. extension kernel against its plain version: a fuzz set (uneven
   lengths, N runs, IUPAC codes, tasks past 10,240 and 12,000 rows and
   one past 65,535 rows + columns) must give identical tuples from the
   kernel, the plain PyTorch version and the native host oracle; then
   kernel, wrapper, plain version and host kernel are timed at ANIm's
   shape (512 tasks of 1,500-3,200 rows, every 8th of 9,900, 12%
   substitutions), and the wrapper against the host kernel over a sweep
   of batch sizes (the measurement behind EXT_BATCH_MIN_CUDA);
4. Smith-Waterman kernel against its plain version the same way: a fuzz
   set (the JAX package's SW test shapes, windows of 2,049, 8,192 and
   32,769 columns, N runs, IUPAC letters and padding codes, tasks with
   no positive cell, fragments past 1,024 rows, and tasks at each side
   of the rule that sends a task to packed 16-bit lanes or to 32-bit
   words, all in the one launch), then timed at ANIb's shape (1,024
   tasks of 1,020-row fragments in windows 300 columns wider) and at
   ANIb's launch shape (that mix 32 times over in one launch, shuffled,
   32,768 tasks);
5. ANIm all-vs-all over 3 synthetic 2 Mb genomes (one ancestor at 2%,
   8% and 15% substitutions, with indels, N runs and IUPAC letters)
   through the port's runner with the extensions on the kernel; a
   share of the ordered pairs rerun with every extension on the native
   host kernel (the CPU production path), rows equal; dnadiff on one
   divergent pair the same way;
6. ANIb all-vs-all over the same genomes with the scoring on the
   kernel, a share of the pairs rerun with the native host scorer, rows
   equal;
7. sourmash (no hand-written kernel; the membership Gram and the device
   sketch are PyTorch on the card): the device Gram on sketch sets that
   stress exactness against the same function on the CPU and scipy; the
   Gram at N = 1,000 (about 2 M hashes) timed against scipy; an
   all-vs-all through the port's runner over 128 genomes of 2.5 Mb in 4
   clades (above the production threshold for the device Gram), rows
   equal to the host containment; the device sketch against the native
   host sketch on the same genomes, hashes bit-identical;
8. the four methods that run on the host (fastANI, skani, ANIminimap2,
   and external-alignment on the genomes' true alignment): the host
   libraries fastani and mm2 built, each method through the port's
   runner over the 2 Mb genomes (9 rows, identity falling with the
   substitution rate where the method reports one), again on the
   runner's static split with rows equal, and no kernel launched;
9. several processes and several devices, on the one card: the Gram at
   N = 1,000 split over a 2 x 2 mesh that names the card four times,
   counts equal to the unsplit Gram; the SW kernel's main shape split over
   the card named twice, tuples equal to one launch; ANIb through the
   runner with the pair-grid mesh replaced by the card named twice, rows
   equal to phase 6's in more launches; ANIm under ``launch -n 2`` with
   private databases, host 0's rows equal to phase 5's, host 1 holding
   its share, both workers' logs showing the card, neither worker
   importing jax or the JAX package. On one card the times show what the
   split costs, not how it scales;
10. neither ``jax`` nor the JAX package ``pyani_plus_tpu`` was imported.

Each main-path run zeroes the launch counts just before it and reads
them just after.

The last lines are the kernels' JSON record (each kernel's time beside
its bound: the larger of its bytes over the card's memory rate and its
integer operations over the card's instruction rate, both counted from this
run's inputs), the card's name and power limit from nvidia-smi, and the
device JSON line.
"""

from __future__ import annotations

import contextlib
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
CLADES = 4  # sourmash: unrelated ancestors
CLADE_SIZE = 32  # descendants of each, at 0.5-5% substitutions
CLADE_LENGTH = 2_500_000
# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and the integer instruction rate taken as one operation per lane per
# clock, half of the 67 TFLOP/s float32 rate (which counts a fused
# multiply-add as two).
MEMORY_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2
# Integer instructions the algorithm needs per DP cell. The extension's
# row spends about 60 on a band column (M, D and I with three payloads,
# the scan element and the best key). A Smith-Waterman cell needs 3: the
# recurrence takes six instructions that no layout can spare (F - ge;
# F = max(H - go - ge, .); G = max(diag + sub, F, 0); one step of E's
# prefix max; H = max(G, E); the running best), and one instruction of the
# card does each for two 16-bit cells. The diagonal's shift, the loads,
# the scan across lanes and the search for the best cell's column are the
# kernel's own cost, not the work's, and are left out: the bound stays
# below any kernel's time.
OPS_PER_CELL = {"extend": 60, "sw": 3}
# What the 32-bit Smith-Waterman kernel spent on a cell, one cell an
# instruction: the yardstick of earlier records, printed beside the bound
# for comparison. The packed kernel spends fewer, so it is no bound.
SW_OPS_32BIT = 20
BAND_COLUMNS = 121
SW_BIG = 32  # the SW kernel's large batch: ANIb's shape this many times
SW_PACKED_ROWS = 16360  # the longest fragment the SW kernel runs in packed 16-bit lanes
SWEEP = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)  # batch sizes of the threshold sweep
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "extend": ("pyani_plus_tpu_torch/csrc/extend.cu",
               "pyani_plus_tpu/ops/extend_pallas.py:97"),
    "sw": ("pyani_plus_tpu_torch/csrc/sw.cu",
           "pyani_plus_tpu/ops/sw_pallas.py:55"),
}


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
    # ANIm's longest tails (9,999 + 200 rows), tasks over 12k rows, and
    # one past 65,535 rows + columns (the kernel's 32-bit payload
    # fields), with N runs and IUPAC letters (codes >= 4)
    for m in (10199, 10199, 12500, 14000, 36000):
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


def bound(name: str, cells: int, nbytes: int) -> dict:
    """The least time the card could take: bytes moved once over the
    memory rate, or the cells' integer operations over the instruction rate."""
    bytes_ms = nbytes / MEMORY_BYTES_PER_S * 1e3
    ops_ms = cells * OPS_PER_CELL[name] / INT_OPS_PER_S * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"   bound: {cells} cells x {OPS_PER_CELL[name]} integer instructions = {ops_ms:.4f} ms "
          f"at {INT_OPS_PER_S:.3e} op/s; {nbytes} bytes = {bytes_ms:.4f} ms at "
          f"{MEMORY_BYTES_PER_S:.3e} B/s; bound by {by}")
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": by, "library_ms": None}


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.monotonic()
        fn()
        times.append((time.monotonic() - t0) * 1e3)
    return float(np.median(times))


def check_kernel(torch, ext) -> dict:
    """Phase 3: the extension kernel against its plain version and the
    host oracle, its times, and the batch-size sweep."""
    from pyani_plus_tpu_torch.methods import anim
    from pyani_plus_tpu_torch.utils import intra_pair_workers

    rng = np.random.default_rng(SEED)
    tasks = fuzz_tasks(rng)
    wide = sum(not ext.uses_packed_fields(task) for task in tasks)
    t0 = phase(f"kernel vs plain: fuzz set of {len(tasks)} tasks "
               f"(longest {max(a.size for a, _ in tasks)} rows, {wide} with 32-bit fields)")
    if not 0 < wide < len(tasks):
        raise AssertionError("the fuzz set must hold tasks of both payload widths")
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
    staging, order = ext.pack_tasks(tasks)
    packed = ext.split_packed(staging.cuda(), len(tasks))
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
    rows = np.empty((len(tasks), 5), np.int32)
    rows[order] = out.cpu().numpy()
    got = [tuple(r) for r in rows.tolist()]

    wrapper_ms = median_ms(lambda: ext.batch_extend_cuda(tasks), 5)
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
    # rows the give-up rule lets a task run: 600 past its last improvement
    run_rows = [min(a.size, r[0] + ext.STOP_ROWS) for (a, _), r in zip(tasks, got)]
    cells = sum(run_rows) * BAND_COLUMNS
    print(f"   identical tuples on all 512 tasks; max_abs_err {err}")
    print(f"   kernel ms per launch (CUDA events, mean of {reps}): {kernel_ms:.4f} "
          f"({cells / kernel_ms / 1e6:.2f} G cells/s; longest task {max(run_rows)} rows, "
          f"{kernel_ms * 1e6 / max(run_rows):.1f} ns a row)")
    print(f"   kernel wrapper ms incl. packing, copies and the event (host clock, "
          f"median of 5): {wrapper_ms:.3f}")
    print(f"   plain PyTorch ms on the CPU (host clock, one run): {plain_ms:.1f}")
    print(f"   native host kernel ms, {workers} threads (host clock): {host_ms:.1f}")
    record = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
              **bound("extend", cells, staging.numel() + out.numel() * 4)}
    # the same mix eight times over, 4,096 tasks: several warps share a
    # scheduler, so the card's rate shows and not one task's latency
    big = ext.split_packed(ext.pack_tasks(tasks * 8)[0].cuda(), len(tasks) * 8)
    ext.extend_cuda(*big)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        ext.extend_cuda(*big)
    stop.record()
    torch.cuda.synchronize()
    big_ms = start.elapsed_time(stop) / reps
    print(f"   kernel ms per launch of {len(tasks) * 8} tasks (the mix eight times, CUDA events, "
          f"mean of {reps}): {big_ms:.4f} ({8 * cells / big_ms / 1e6:.2f} G cells/s)")
    done("timing", t0)

    # Pair threads launch side by side, each on its own stream.
    import threading
    from concurrent.futures import ThreadPoolExecutor

    t0 = phase("4 threads, each one batch of 128 main-shape tasks on its own stream")
    shares = [tasks[i::4] for i in range(4)]
    one_ms = median_ms(lambda: ext.batch_extend_cuda(shares[0]), 5)
    gate = threading.Barrier(4)

    def together(share):
        gate.wait()  # all four threads submit at once
        return ext.batch_extend_cuda(share)

    rounds = []
    with ThreadPoolExecutor(max_workers=4) as pool:
        for _ in range(7):  # the first rounds make each thread's stream and buffers
            t1 = time.monotonic()
            results = list(pool.map(together, shares))
            rounds.append((time.monotonic() - t1) * 1e3)
    if [r for share in results for r in share] != [got[i] for s in range(4) for i in range(s, 512, 4)]:
        raise AssertionError("threaded batches disagree with the single launch")
    print(f"   one batch alone ms (median of 5): {one_ms:.3f}; four batches from four threads "
          f"ms (median of the last 5 of 7 rounds): {float(np.median(rounds[2:])):.3f} "
          f"(all {[round(r, 3) for r in rounds]})")
    # the kernels alone, from one thread: four streams against one
    streams = [torch.cuda.Stream() for _ in shares]
    on_card = [ext.split_packed(ext.pack_tasks(s)[0].cuda(), len(s)) for s in shares]
    torch.cuda.synchronize()

    def four_kernels(side_by_side: bool) -> None:
        for stream, views in zip(streams, on_card):
            with torch.cuda.stream(stream if side_by_side else torch.cuda.current_stream()):
                ext.extend_cuda(*views)
        torch.cuda.synchronize()

    print(f"   four kernels of 128 tasks from one thread (host clock to the device's end, "
          f"median of 5): on four streams {median_ms(lambda: four_kernels(True), 5):.3f} ms, "
          f"on one stream {median_ms(lambda: four_kernels(False), 5):.3f} ms")
    done("streams", t0)

    workers = intra_pair_workers()
    t0 = phase(f"batch-size sweep: wrapper vs native host kernel on {workers} threads "
               "(host clock, median of 5)")
    short = [(a[:m], b[:m]) for (a, b), m in zip(tasks, rng.integers(150, 700, len(tasks)))]
    crossover = 0
    for mix, pool_tasks in (("main-shape mix", tasks), ("tails of 150-700 rows", short)):
        wins_from = None
        for size in SWEEP:
            batch = pool_tasks[:size]
            card_ms = median_ms(lambda: ext.batch_extend_cuda(batch), 5)
            # as _run_extensions runs them: a thread pool only past 4 tasks
            host_workers = workers if size > 4 else 1
            host_ms = median_ms(lambda: ext.batch_extend_host(batch, workers=host_workers), 5)
            wins = card_ms < host_ms
            wins_from = (wins_from or size) if wins else None
            print(f"   {mix}, {size:4d} tasks: wrapper {card_ms:9.3f} ms, host kernel "
                  f"{host_ms:9.3f} ms{'  card wins' if wins else ''}")
        if wins_from is None:
            raise AssertionError(f"the card never wins on the {mix}")
        crossover = max(crossover, wins_from)
    print(f"   smallest batch from which the card wins at every larger size, both mixes: "
          f"{crossover}; EXT_BATCH_MIN_CUDA = {anim.EXT_BATCH_MIN_CUDA}")
    done("sweep", t0)
    return record


def homolog(frag: np.ndarray, rate: float, width: int,
            rng: np.random.Generator) -> np.ndarray:
    """A window of `width` codes holding `frag` at `rate` substitutions,
    with short indels, between random flanks."""
    from pyani_plus_tpu_torch.synthetic import mutate

    text = mutate(np.frombuffer(b"ACGT", np.uint8)[frag % 4], rate, rng)
    core = encode(text)
    left = int(rng.integers(0, max(1, width - core.size)))
    window = rng.integers(0, 4, width).astype(np.uint8)
    core = core[: width - left]
    window[left : left + core.size] = core
    return window


def sw_fuzz_tasks(rng: np.random.Generator) -> list[tuple[np.ndarray, np.ndarray]]:
    from pyani_plus_tpu_torch.synthetic import salt

    tasks = []
    # tests/test_anib.py's Pallas SW shapes: m <= 128, n <= 256, N codes
    for trial in range(24):
        m = int(rng.integers(1, 129))
        n = int(rng.integers(1, 257))
        hi = 5 if trial % 3 else 4
        q = rng.integers(0, hi, m).astype(np.uint8)
        s = rng.integers(0, hi, n).astype(np.uint8)
        if trial % 4 == 0 and n > m:
            s[:m] = q
            mut = rng.random(m) < 0.2
            s[:m][mut] = (s[:m][mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        tasks.append((q, s))
    # tests/test_dp.py's trim-equivalence shapes
    for _ in range(24):
        m = int(rng.integers(20, 90))
        n = int(rng.integers(30, 140))
        q = rng.integers(0, 5, m).astype(np.uint8)
        s = rng.integers(0, 5, n).astype(np.uint8)
        if rng.random() < 0.7:
            ln = min(m, n) // 2
            s[:ln] = q[:ln]
        tasks.append((q, s))
    # wide windows, and fragments past 1,024 rows
    for m, n in ((1020, 2049), (1020, 8192), (1020, 32769), (1500, 1800), (3000, 3300)):
        q = rng.integers(0, 4, m).astype(np.uint8)
        tasks.append((q, homolog(q, 0.08, n, rng)))
    # N runs of 56 and more, IUPAC letters and padding codes (5)
    for _ in range(6):
        q = rng.integers(0, 4, 1020).astype(np.uint8)
        s = homolog(q, 0.05, 1320, rng)
        q_txt = np.frombuffer(b"ACGT", np.uint8)[q]
        salt(q_txt, rng, n_runs=2)
        q = encode(q_txt)
        start = int(rng.integers(0, 900))
        q[start : start + int(rng.integers(56, 120))] = 4
        s[rng.random(s.size) < 0.01] = 5
        tasks.append((q, s))
    # no positive cell: all N, and letters that never meet
    tasks.append((np.full(300, 4, np.uint8), rng.integers(0, 4, 600).astype(np.uint8)))
    tasks.append((np.zeros(200, np.uint8), np.full(500, 1, np.uint8)))
    tasks.append((np.full(100, 5, np.uint8), np.full(100, 5, np.uint8)))
    # both sides of the kernel's width rule (packed 16-bit lanes up to
    # min(m, n) = 16,360), in the one launch: a perfect copy that ends in a
    # lane's last column, which is the largest value a packed word is asked
    # to hold (score 32,720 plus the E scan's offset of 46); and on the
    # 32-bit path one row more, a homolog; a fragment longer than its
    # window; N runs and padding codes; and a task with no positive cell.
    # A generator of their own leaves `rng` where it was, so the main
    # shape's tasks stay those of earlier runs.
    own = np.random.default_rng(SEED + 4)
    q = own.integers(0, 4, SW_PACKED_ROWS).astype(np.uint8)
    flanks = own.integers(0, 4, (2, 56)).astype(np.uint8)  # 56 + 16,360 = 24 * 684
    tasks.append((q, np.concatenate([flanks[0], q, flanks[1]])))
    q = own.integers(0, 4, SW_PACKED_ROWS + 1).astype(np.uint8)
    tasks.append((q, homolog(q, 0.03, q.size + 200, own)))
    q = own.integers(0, 4, 17000).astype(np.uint8)
    tasks.append((q, homolog(q, 0.06, 16500, own)))
    q = own.integers(0, 4, 16400).astype(np.uint8)
    s = homolog(q, 0.04, 18000, own)
    q[5000:5080] = 4
    q[own.random(q.size) < 0.005] = ord("R")  # an IUPAC letter, as encode() leaves it
    s[own.random(s.size) < 0.01] = 5
    tasks.append((q, s))
    tasks.append((np.full(16400, 4, np.uint8), own.integers(0, 4, 16400).astype(np.uint8)))
    return tasks


def sw_main_tasks(rng: np.random.Generator) -> list[tuple[np.ndarray, np.ndarray]]:
    """ANIb's shape: 1,024 tasks, 1,020-row fragments (every 16th a tail
    of 40-1,019), windows 300 columns wider, 60% homologous at 2-15%."""
    tasks = []
    for t in range(1024):
        m = 1020 if t % 16 else int(rng.integers(40, 1020))
        q = rng.integers(0, 4, m).astype(np.uint8)
        if rng.random() < 0.6:
            s = homolog(q, float(rng.uniform(0.02, 0.15)), m + 300, rng)
        else:
            s = rng.integers(0, 4, m + 300).astype(np.uint8)
        tasks.append((q, s))
    return tasks


def check_sw_kernel(torch, sw) -> dict:
    """Phase 4: the SW kernel against its plain version and the oracle."""
    rng = np.random.default_rng(SEED + 1)
    workers = os.cpu_count() or 1
    tasks = sw_fuzz_tasks(rng)
    t0 = phase(f"SW kernel vs plain: fuzz set of {len(tasks)} tasks (longest "
               f"fragment {max(q.size for q, _ in tasks)} rows, widest window "
               f"{max(s.size for _, s in tasks)} columns)")
    narrow = [sw.uses_packed_lanes(q.size, s.size) for q, s in tasks]
    if sum(narrow) < 4 or len(narrow) - sum(narrow) < 4:
        raise AssertionError("the SW fuzz set must hold several tasks of each width")
    got = sw.batch_sw_best_cuda(tasks)
    torch.cuda.synchronize()
    plain = sw.batch_sw_best_reference(tasks)
    host = sw.batch_sw_best_host(tasks, workers=workers)
    if got != plain or got != host:
        bad = [i for i in range(len(tasks)) if not got[i] == plain[i] == host[i]]
        msg = (f"SW kernel disagrees on tasks {bad[:10]} (kernel, plain, native): "
               f"{[(got[i], plain[i], host[i]) for i in bad[:3]]}")
        raise AssertionError(msg)
    if not any(r[0] == 0 for r in got) or not any(r[1] > 1024 for r in got):
        raise AssertionError("the SW fuzz set lost its no-alignment or long-fragment tasks")
    wide_scores = [r[0] for r, packed_lanes in zip(got, narrow) if not packed_lanes]
    if min(wide_scores) != 0 or sum(score > 20000 for score in wide_scores) < 3:
        raise AssertionError("the SW fuzz set lost its tasks on the 32-bit path")
    edge = [sw.uses_packed_lanes(SW_PACKED_ROWS + extra, 1 << 20) for extra in (0, 1)]
    if edge != [True, False] or max(r[0] for r in got) != 2 * SW_PACKED_ROWS:
        raise AssertionError("the SW fuzz set lost the task at the edge of the packed lanes")
    err = max_abs_err(got, plain)
    print(f"   identical (score, best_i, best_j): kernel == plain == native on {len(tasks)} tasks, "
          f"{sum(narrow)} in packed 16-bit lanes and {len(tasks) - sum(narrow)} in 32-bit words "
          f"in the one launch")
    done("SW fuzz", t0)

    tasks = sw_main_tasks(rng)
    cells = sum(q.size * s.size for q, s in tasks)
    t0 = phase(f"SW kernel vs plain at ANIb's shape: 1024 tasks, {cells} cells")
    packed = [t.cuda() for t in sw.pack_tasks(tasks)]
    out = sw.sw_cuda(*packed)  # warm
    torch.cuda.synchronize()
    reps = 10
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        sw.sw_cuda(*packed)
    stop.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(stop) / reps
    got = [tuple(r) for r in out.cpu().tolist()]

    t1 = time.monotonic()
    sw.batch_sw_best_cuda(tasks)
    wrapper_ms = (time.monotonic() - t1) * 1e3
    t1 = time.monotonic()
    plain = sw.batch_sw_best_reference(tasks)
    plain_ms = (time.monotonic() - t1) * 1e3
    t1 = time.monotonic()
    host = sw.batch_sw_best_host(tasks, workers=workers)
    host_ms = (time.monotonic() - t1) * 1e3
    if got != plain or got != host:
        raise AssertionError("SW kernel disagrees with the plain version at ANIb's shape")
    err = max(err, max_abs_err(got, plain))
    print(f"   identical tuples on all 1024 tasks; max_abs_err {err}")
    print(f"   kernel ms per launch (CUDA events, mean of {reps}): {kernel_ms:.4f}"
          f" ({cells / kernel_ms / 1e6:.2f} G cell updates/s)")
    print(f"   kernel wrapper ms incl. packing and copies (host clock): {wrapper_ms:.3f}")
    print(f"   plain PyTorch ms on the CPU (host clock, one run): {plain_ms:.1f}")
    print(f"   native score + stats DPs ms, {workers} threads (host clock): {host_ms:.1f}")
    nbytes = sum(int(x.numel()) * x.element_size() for x in packed) + out.numel() * 4
    record = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
              **bound("sw", cells, nbytes)}
    # not a bound: the 32-bit kernel's instructions at the card's rate
    record["ops_32bit_ms"] = cells * SW_OPS_32BIT / INT_OPS_PER_S * 1e3
    print(f"   share of the bound: {record['bound_ms'] / kernel_ms:.3f}; for comparison with "
          f"earlier records, {SW_OPS_32BIT} instructions a cell (the 32-bit kernel's count) "
          f"would take {record['ops_32bit_ms']:.4f} ms, {record['ops_32bit_ms'] / kernel_ms:.3f} "
          f"of the kernel's time")
    done("SW timing", t0)

    # ANIb's launch shape: the same mix SW_BIG times over in one launch, so
    # that every scheduler holds several warps and the card's rate shows;
    # shuffled, so that a task meets other blocks, warps and neighbours
    # than in the launch compared above
    t0 = phase(f"SW kernel at ANIb's launch shape: {SW_BIG * len(tasks)} tasks, "
               f"{SW_BIG * cells} cells in one launch")
    order = np.random.default_rng(SEED + 5).permutation(SW_BIG * len(tasks)) % len(tasks)
    big = [t.cuda() for t in sw.pack_tasks([tasks[t] for t in order])]
    big_out = sw.sw_cuda(*big)  # warm
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        sw.sw_cuda(*big)
    stop.record()
    torch.cuda.synchronize()
    big_ms = start.elapsed_time(stop) / 3
    # every task must give the row that its copy among the 1,024 gave,
    # which was compared with the plain version and the oracle above
    if [tuple(r) for r in big_out.cpu().tolist()] != [got[t] for t in order]:
        raise AssertionError("SW kernel disagrees with itself in the large batch")
    big_bound = SW_BIG * cells * OPS_PER_CELL["sw"] / INT_OPS_PER_S * 1e3
    big_32bit = SW_BIG * cells * SW_OPS_32BIT / INT_OPS_PER_S * 1e3
    print(f"   identical tuples on all {SW_BIG * len(tasks)} tasks ({SW_BIG} shuffled copies "
          f"of the rows compared above)")
    print(f"   kernel ms per launch (CUDA events, mean of 3): {big_ms:.4f} "
          f"({SW_BIG * cells / big_ms / 1e6:.2f} G cell updates/s); bound {big_bound:.4f} ms at "
          f"{OPS_PER_CELL['sw']} instructions a cell, share {big_bound / big_ms:.3f}; "
          f"{SW_OPS_32BIT} a cell would take {big_32bit:.4f} ms, {big_32bit / big_ms:.3f} of the "
          f"kernel's time")
    if big_bound > big_ms or record["bound_ms"] > kernel_ms:
        raise AssertionError("the SW kernel beat its bound: the bound is wrong")
    record["large_batch_tasks"] = SW_BIG * len(tasks)
    record["large_batch_ms"] = big_ms
    record["large_batch_bound_ms"] = big_bound
    done("SW large batch", t0)
    return record


def comparison_rows(db: Path) -> list[tuple]:
    with sqlite3.connect(db) as conn:
        return conn.execute(
            "SELECT g1.path, g2.path, c.identity, c.aln_length, c.sim_errors,"
            " c.cov_query, c.cov_subject FROM comparisons c"
            " JOIN genomes g1 ON g1.genome_hash = c.query_hash"
            " JOIN genomes g2 ON g2.genome_hash = c.subject_hash"
            " ORDER BY g1.path, g2.path"
        ).fetchall()


# The host reruns compute a share of the ordered pairs: the runner's
# static split of the pair grid (every pair with (q * n + s) % 2 == 1),
# one pair at a time, so that each pair's thousands of host extensions
# spread over all cores instead of running on its pair thread alone.
HOST_SHARE = {"PYANI_TPU_PROCESS_COUNT": "2", "PYANI_TPU_PROCESS_INDEX": "1",
              "PYANI_TPU_PAIR_WORKERS": "1"}


def run_method(kernel, runner, logger, work: Path, fasta: Path, method: str,
               tag: str, *, host_env: dict[str, str] | None) -> tuple[list[tuple], int, float]:
    """One run through the port's runner with `kernel`'s launch counts
    zeroed just before it; `host_env` sends the work to the native host
    kernels instead, for a share of the pairs. Returns (rows, kernel
    launches, wall seconds)."""
    from pyani_plus_tpu_torch.utils import devmeter

    db = work / f"{tag}.db"
    host_env = {**host_env, **HOST_SHARE} if host_env else {}
    os.environ.update(host_env)
    kernel.reset_counts()
    t0 = phase(f"{method} {tag}: {'native host' if host_env else 'CUDA kernel'}")
    window = devmeter.reset()
    try:
        runner.start_and_run_method(logger, db, fasta, method, create_db=True)
    finally:
        for key in host_env:
            os.environ.pop(key, None)
    launches, tasks = kernel.LAUNCHES, kernel.TASKS
    seconds = time.monotonic() - t0
    busy = devmeter.busy_fraction(window)
    done(tag, t0)
    print(f"   kernel launches {launches}, tasks through the kernel {tasks}")
    print(f"   device busy share (devmeter, submit to sync of each launch): {busy:.4f}")
    return comparison_rows(db), launches, seconds


def check_identity_order(method: str, rows: list[tuple]) -> None:
    identity = {(Path(q).stem, Path(s).stem): r[0] for q, s, *r in rows}
    for key in sorted(identity):
        print(f"   {method} identity {key[0]} vs {key[1]}: {identity[key]!r}")
    # more substitutions, lower identity (or none reported, as skani
    # reports none below its aligned-fraction screen)
    near, far = identity[("genome_0", "genome_1")], identity[("genome_0", "genome_2")]
    if near is None or (far is not None and not near > far):
        raise AssertionError(f"{method} identities are out of order")


def check_anim_path(ext, runner, logger, work: Path,
                    paths: list[Path]) -> tuple[int, list[tuple], float]:
    """Phase 5: ANIm all-vs-all and a dnadiff pair, kernel vs host rows.
    Returns ANIm's kernel launches, rows and wall seconds."""
    # above every batch: all extensions on the native host kernel
    host_env = {"PYANI_TPU_EXTEND_BATCH_MIN": str(1 << 40)}
    genomes = paths[0].parent
    rows, launches, seconds = run_method(ext, runner, logger, work, genomes, "ANIm",
                                         "anim_kernel", host_env=None)
    if launches == 0:
        raise AssertionError("the ANIm run never launched the kernel")
    host_rows, host_launches, _ = run_method(ext, runner, logger, work, genomes,
                                             "ANIm", "anim_host", host_env=host_env)
    check_rows("ANIm", rows, host_rows, len(RATES) ** 2, 4)
    if host_launches:
        raise AssertionError("the host run launched the kernel")
    check_identity_order("ANIm", rows)

    pair = work / "pair"
    pair.mkdir()
    for path in paths[:2]:
        shutil.copy(path, pair / path.name)
    rows2, launches2, _ = run_method(ext, runner, logger, work, pair, "dnadiff",
                                     "dnadiff_kernel", host_env=None)
    host2, _, _ = run_method(ext, runner, logger, work, pair, "dnadiff",
                             "dnadiff_host", host_env=host_env)
    check_rows("dnadiff", rows2, host2, 4, 2)
    if launches2 == 0:
        raise AssertionError("the dnadiff run never launched the kernel")
    return launches, rows, seconds


def check_anib_path(sw, runner, logger, work: Path,
                    paths: list[Path]) -> tuple[int, list[tuple]]:
    """Phase 6: ANIb all-vs-all, kernel scoring vs the native host scorer.
    Returns its kernel launches and rows."""
    genomes = paths[0].parent
    rows, launches, _ = run_method(sw, runner, logger, work, genomes, "ANIb",
                                   "anib_kernel", host_env=None)
    if launches == 0:
        raise AssertionError("the ANIb run never launched the kernel")
    host_rows, host_launches, _ = run_method(sw, runner, logger, work, genomes, "ANIb",
                                             "anib_host",
                                             host_env={"PYANI_TPU_ANIB_DEVICE": "0"})
    check_rows("ANIb", rows, host_rows, len(RATES) ** 2, 4)
    if host_launches:
        raise AssertionError("the ANIb host run launched the kernel")
    check_identity_order("ANIb", rows)
    return launches, rows


def check_rows(method: str, rows: list[tuple], host: list[tuple], count: int,
               host_count: int) -> None:
    if len(rows) != count:
        raise AssertionError(f"{method}: {len(rows)} rows, expected {count}")
    if len(host) != host_count:
        raise AssertionError(f"{method}: {len(host)} host rows, expected {host_count}")
    if not any(row[0] != row[1] for row in host):
        raise AssertionError(f"{method}: the host share holds only self-pairs")
    by_pair = {row[:2]: row for row in rows}
    for row in host:  # integers exact, floats ==
        if by_pair.get(row[:2]) != row:
            raise AssertionError(f"{method}: kernel row differs from host row {row}")
    for row in rows:
        identity = row[2]
        if identity is None or not 0.5 < identity <= 1.0 or not np.isfinite(identity):
            raise AssertionError(f"{method}: implausible identity in {row}")
    print(f"   {method}: {count} rows; the {host_count} pairs rerun on the host kernels "
          "are equal (ints exact, floats ==)")


@contextlib.contextmanager
def stage_timers(stages: list[tuple[object, str, str]]):
    """Time calls of `owner.attr` under `label` for each stage, summed
    over calls; yields {label: [seconds, calls]} and restores the
    attributes after."""
    totals: dict[str, list] = {}
    saved = []
    for owner, attr, label in stages:
        real = getattr(owner, attr)
        totals[label] = [0.0, 0]

        def timed(*args, _real=real, _label=label, **kwargs):
            t0 = time.monotonic()
            try:
                return _real(*args, **kwargs)
            finally:
                totals[_label][0] += time.monotonic() - t0
                totals[_label][1] += 1

        setattr(owner, attr, timed)
        saved.append((owner, attr, real))
    try:
        yield totals
    finally:
        for owner, attr, real in reversed(saved):
            setattr(owner, attr, real)


def check_gram_fuzz(torch, minhash) -> None:
    """Phase 7a: the device Gram on sketch sets that stress exactness,
    against the same function on the CPU and the host Gram (scipy)."""
    from pyani_plus_tpu_torch.synthetic import gram_fuzz_sets

    sets = gram_fuzz_sets(SEED + 2, 70)
    t0 = phase(f"sourmash Gram fuzz: {len(sets)} sketch sets, blocks of 4096 and 128")
    for name, sketches in sets.items():
        host = minhash.intersection_matrix_host(sketches)
        for block in (4096, 128):
            got = minhash.intersection_matrix_device(sketches, block=block)
            torch.cuda.synchronize()
            cpu = minhash.intersection_matrix_device(sketches, block=block, device="cpu")
            if not (np.array_equal(got, cpu) and np.array_equal(got, host)):
                raise AssertionError(f"device Gram differs on set {name!r} at block {block}")
        off = host[~np.eye(len(sketches), dtype=bool)]
        print(f"   {name}: {len(sketches)} sketches, {sum(s.num_hashes for s in sketches)} "
              f"hashes, pair counts {off.min() if off.size else 0}-{off.max() if off.size else 0}:"
              " card == CPU == scipy")
    done("Gram fuzz", t0)


def check_gram_scale(torch, minhash) -> tuple[list, np.ndarray]:
    """Phase 7b: the Gram at N = 1,000 on the card against scipy. Returns
    the sketches and their counts."""
    from pyani_plus_tpu_torch.synthetic import clade_sketches

    t1 = time.monotonic()
    sketches = clade_sketches(SEED + 3, 1000, 40)
    n = len(sketches)
    total = sum(s.num_hashes for s in sketches)
    t0 = phase(f"sourmash Gram at scale: {n} sketches in 40 clades, {total} hashes "
               f"(made in {time.monotonic() - t1:.3f} s)")
    t1 = time.monotonic()
    got = minhash.intersection_matrix_device(sketches)
    call_s = time.monotonic() - t1
    t1 = time.monotonic()
    pts = minhash.incidence(sketches, 4096)
    prep_s = time.monotonic() - t1
    pts_dev = torch.from_numpy(pts).cuda()
    minhash.gram(pts_dev, n, 4096)  # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        minhash.gram(pts_dev, n, 4096)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    gram_ms = float(np.median(times))
    counts_dev = torch.zeros((n, n), dtype=torch.float64, device="cuda")
    copy_times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        counts_dev.to(torch.int64).cpu().numpy()
        stop.record()
        torch.cuda.synchronize()
        copy_times.append(start.elapsed_time(stop))
    t1 = time.monotonic()
    host = minhash.intersection_matrix_host(sketches)
    host_s = time.monotonic() - t1
    if not np.array_equal(got, host):
        raise AssertionError("device Gram differs from scipy at N = 1000")
    blocks = pts.shape[0]
    flops = 2.0 * n * n * 4096 * blocks
    print(f"   union blocks of 4096: {blocks}, incidence per block up to {pts.shape[1]}")
    print(f"   device Gram ms (CUDA events, median of 5, the counts' copy to the host "
          f"included): {gram_ms:.3f} "
          f"(all {[round(t, 3) for t in times]}; {flops / gram_ms / 1e9:.2f} TFLOP/s fp32)")
    print(f"   of which the counts' conversion to int64 and copy to the host ms (CUDA events, "
          f"median of 5): {float(np.median(copy_times)):.3f}")
    print(f"   union and ids on the host s: {prep_s:.3f}; whole call s (host clock): {call_s:.3f}")
    print(f"   scipy host Gram s (host clock, one run): {host_s:.3f}; counts equal")
    done("Gram at scale", t0)
    return sketches, got


def check_sourmash_path(minhash, runner, logger, work: Path) -> None:
    """Phase 7c: sourmash all-vs-all through the port's runner on 128
    genomes of 2.5 Mb, rows against the host containment; then the device
    sketch against the native host sketch on the same genomes."""
    from pyani_plus_tpu_torch.db import Database, Run
    from pyani_plus_tpu_torch.genomes import load_genome
    from pyani_plus_tpu_torch.methods import sourmash
    from pyani_plus_tpu_torch.utils import devmeter
    from pyani_plus_tpu_torch.synthetic import write_clade_dir

    rates = [float(r) for r in np.linspace(0.005, 0.05, CLADE_SIZE)]
    t0 = phase(f"write {CLADES} clades x {CLADE_SIZE} genomes of {CLADE_LENGTH} bp")
    paths = write_clade_dir(work / "clades", CLADE_LENGTH, CLADES, rates, SEED)
    done("clade genomes", t0)

    db = work / "sourmash.db"
    cache = work / "cache"
    stages = [
        (runner, "index_fasta_directory", "ingest: index and MD5"),
        (runner, "_setup_run", "store: genome, configuration and run rows"),
        (runner, "load_genome", "ingest: load genomes"),
        (sourmash, "get_sketch", "host sketching (native, .npy cache)"),
        (minhash, "intersection_matrix_device", "device Gram call"),
        (minhash, "incidence", "  of which union and ids (host)"),
        (minhash, "ani_from_counts", "numpy tail"),
        (Database, "insert_comparisons", "store: comparisons"),
        (Run, "cache_comparisons", "store: matrix cache"),
    ]
    minhash.reset_counts()
    t0 = phase(f"sourmash all-vs-all: {len(paths)} genomes through the port's runner")
    window = devmeter.reset()
    with stage_timers(stages) as totals:
        runner.start_and_run_method(logger, db, paths[0].parent, "sourmash",
                                    create_db=True, cache=cache)
    launches = minhash.LAUNCHES
    busy = devmeter.busy_fraction(window)
    done("sourmash run", t0)
    for label, (seconds, calls) in totals.items():
        print(f"   stage {label}: {seconds:.3f} s ({calls} calls)")
    print(f"   device Gram calls on the card: {launches}; "
          f"device busy share (devmeter): {busy:.4f}")

    with sqlite3.connect(db) as conn:
        rows = conn.execute(
            "SELECT query_hash, subject_hash, identity, cov_query FROM comparisons"
        ).fetchall()
        clade = {h: Path(p).name.split("_genome")[0]
                 for h, p in conn.execute("SELECT genome_hash, path FROM genomes")}
    md5s = sorted(clade)
    sketch_dir = cache / "sourmash_k=31_scaled=1000"
    sketches = [minhash.Sketch(h, 31, 1000, np.load(sketch_dir / f"{h}.npy")) for h in md5s]
    total = sum(s.num_hashes for s in sketches)
    print(f"   {len(md5s)} sketches, {total} hashes "
          f"({min(s.num_hashes for s in sketches)}-{max(s.num_hashes for s in sketches)} each)")
    if not (len(md5s) >= 64 and total > 1 << 18):
        raise AssertionError("the run is below the production threshold for the device Gram")
    if launches == 0:
        raise AssertionError("the sourmash run never ran the Gram on the card")
    identity, cov = minhash.containment_ani(sketches, use_device=False)
    index = {h: i for i, h in enumerate(md5s)}
    if len(rows) != len(md5s) ** 2:
        raise AssertionError(f"sourmash: {len(rows)} rows, expected {len(md5s) ** 2}")
    within = []
    for q, s, ident, c in rows:
        i, j = index[q], index[s]
        expected = tuple(None if np.isnan(v) else float(v) for v in (identity[i, j], cov[i, j]))
        if (ident, c) != expected:
            raise AssertionError(f"sourmash row {q} {s}: {(ident, c)} != host {expected}")
        if (ident is None) != (clade[q] != clade[s]):
            raise AssertionError(f"sourmash row {q} {s}: identity {ident} across clades")
        if q == s and ident != 1.0:
            raise AssertionError(f"sourmash self-row {q}: identity {ident}")
        if ident is not None and q != s:
            within.append(ident)
    print(f"   {len(rows)} rows == host containment (scipy), floats ==; None across clades; "
          f"1.0 on the diagonal; identity within clades {min(within):.6f}-{max(within):.6f}")

    t0 = phase(f"device sketch vs native host sketch on {len(paths)} genomes")
    genomes = [load_genome(p) for p in paths]
    t1 = time.monotonic()
    host = [minhash.sketch_genome(g, 31, 1000) for g in genomes]
    host_s = time.monotonic() - t1
    minhash.sketch_genomes_device(genomes[:1], 31, 1000)  # warm
    device_s = []
    for _ in range(2):
        t1 = time.monotonic()
        dev = minhash.sketch_genomes_device(genomes, 31, 1000)
        device_s.append(time.monotonic() - t1)
        for g, h, d in zip(genomes, host, dev, strict=True):
            if not np.array_equal(h.hashes, d.hashes):
                raise AssertionError(f"device sketch differs from the native sketch on {g.md5}")
    bases = sum(r.codes.size for g in genomes for r in g.records)
    print(f"   {bases} bases: native host sketch s (one thread, host clock): {host_s:.3f}")
    print(f"   device sketch s (host clock, incl. copies and np.unique; two runs): "
          f"{device_s[0]:.3f}, {device_s[1]:.3f}; hashes bit-identical")
    done("device sketch", t0)


# The four methods that run on the host, in the JAX package and the port alike
HOST_METHODS = ("fastANI", "skani", "ANIminimap2", "external-alignment")


def check_host_methods(kernels, _build, runner, logger, work: Path, alignment: Path) -> None:
    """Phase 8: fastANI, skani, ANIminimap2 and external-alignment (on the
    genomes' true alignment) through the port's runner on the smoke's
    genomes; each again on the runner's static split, rows equal. They
    launch no kernel."""
    t0 = phase("host libraries of the four methods (g++, set-up)")
    for name in ("fastani", "mm2"):
        if _build.load_host_library(name) is None:
            raise AssertionError(f"the host library {name} did not build")
        print(f"   {name}: g++ build seconds (set-up): {_build.BUILD_INFO[f'host:{name}'][0]:.3f}")
    done("host libraries", t0)
    genomes = alignment.parent
    for method in HOST_METHODS:
        params = {}
        if method == "external-alignment":
            params = {"alignment": alignment, "extra_files": {"alignment": alignment}}
        rows = {}
        for tag, env in (("all", {}), ("share", HOST_SHARE)):
            db = work / f"{method}_{tag}.db"
            os.environ.update(env)
            for kernel in kernels:
                kernel.reset_counts()
            t0 = phase(f"{method} ({'all pairs' if not env else 'the static share of host 1 of 2'})")
            try:
                runner.start_and_run_method(logger, db, genomes, method, create_db=True,
                                            cache=work / "cache", **params)
            finally:
                for key in env:
                    os.environ.pop(key, None)
            done(f"{method} {tag}", t0)
            if any(kernel.LAUNCHES for kernel in kernels):
                raise AssertionError(f"{method} launched a kernel")
            rows[tag] = comparison_rows(db)
        if len(rows["all"]) != len(RATES) ** 2 or len(rows["share"]) != 4:
            raise AssertionError(f"{method}: {len(rows['all'])} rows, share {len(rows['share'])}")
        by_pair = {row[:2]: row for row in rows["all"]}
        if not all(by_pair[row[:2]] == row for row in rows["share"]):
            raise AssertionError(f"{method}: the static share's rows differ")
        check_identity_order(method, rows["all"])
        print(f"   {method}: {len(rows['all'])} rows; the share's 4 rows equal (ints exact, floats ==)")


# The launch workers' interpreters refuse jax and the JAX package, and
# each writes down at exit which of them it holds, how many times it
# launched the extension kernel and which card was current.
WORKER_SITE_HOOK = """
import atexit, json, os, sys
FOREIGN = ("jax", "jaxlib", "pyani_plus_tpu")
class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FOREIGN:
            raise ImportError("refused in the smoke's launch workers: " + name)
sys.meta_path.insert(0, _Refuse())
@atexit.register
def _report():
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
    extend = sys.modules.get("pyani_plus_tpu_torch.ops.extend")
    backend = sys.modules.get("pyani_plus_tpu_torch.backend")
    report = {"foreign": loaded, "extend_launches": extend.LAUNCHES if extend else None,
              "device": str(backend.kernel_device()) if backend else None}
    with open(os.path.join(os.environ["SMOKE_WORKER_REPORTS"], str(os.getpid())), "w") as out:
        out.write(json.dumps(report))
"""


def check_split_paths(torch, minhash, sw, runner, logger, work: Path, genomes: Path,
                      gram_scale: tuple, anim: tuple, anib: tuple, smi: str) -> None:
    """Phase 9: several processes and several devices, on the one card.

    (a) the Gram at N = 1,000 split over a 2 x 2 mesh that names the card
    four times; (b) the SW kernel's main shape split over the card named
    twice; (c) ANIb through the runner with the pair-grid mesh replaced by
    the card named twice; (d) ANIm under `launch -n 2` with private
    databases. On one card these timings show what the split costs, not
    how it scales: every part runs on the same card, in turn.
    """
    from pyani_plus_tpu_torch.parallel import distributed, tiles

    card = torch.device("cuda", 0)
    sketches, counts = gram_scale
    n = len(sketches)
    t0 = phase(f"split Gram: N = {n} over a 2 x 2 mesh of the one card")
    mesh = tiles.make_mesh(devices=[card] * 4)
    if mesh.shape != (2, 2):
        raise AssertionError(f"mesh of 4 entries is {mesh.shape}")
    pts = minhash.incidence(sketches, 4096)

    def unsplit():
        return minhash.gram(torch.from_numpy(pts).to(card), n, 4096)

    unsplit()  # warm
    unsplit_ms = median_ms(unsplit, 3)
    split = minhash.gram(pts, n, 4096, mesh)
    split_ms = median_ms(lambda: minhash.gram(pts, n, 4096, mesh), 3)
    if not np.array_equal(split, counts) or not np.array_equal(unsplit(), counts):
        raise AssertionError("the split Gram differs from the unsplit Gram")
    print(f"   counts equal (split == unsplit == scipy); host clock to the counts on the host, "
          f"median of 3: unsplit {unsplit_ms:.3f} ms, split 2 x 2 {split_ms:.3f} ms ({smi})")
    done("split Gram", t0)

    tasks = sw_main_tasks(np.random.default_rng(SEED + 6))
    t0 = phase(f"split SW: {len(tasks)} main-shape tasks over the card named twice")
    one = sw.batch_sw_best_cuda(tasks, device=card)
    before = sw.LAUNCHES
    halves = sw.batch_sw_best(tasks, [card, card])
    if sw.LAUNCHES != before + 2:
        raise AssertionError(f"the split SW made {sw.LAUNCHES - before} launches, not 2")
    if halves != one:
        raise AssertionError("the split SW differs from one launch")
    one_ms = median_ms(lambda: sw.batch_sw_best_cuda(tasks, device=card), 5)
    halves_ms = median_ms(lambda: sw.batch_sw_best(tasks, [card, card]), 5)
    print(f"   identical tuples on all {len(tasks)} tasks; wrapper ms incl. packing and copies "
          f"(host clock, median of 5): one launch {one_ms:.3f}, two slices {halves_ms:.3f} ({smi})")
    done("split SW", t0)

    anib_launches, anib_rows = anib
    mesh = tiles.make_mesh(devices=[card, card])
    real = tiles.default_pair_mesh
    tiles.default_pair_mesh = lambda: mesh
    try:
        rows, launches, seconds = run_method(sw, runner, logger, work, genomes, "ANIb",
                                             "anib_mesh", host_env=None)
    finally:
        tiles.default_pair_mesh = real
    if rows != anib_rows:
        raise AssertionError("ANIb through the mesh differs from phase 6's rows")
    if not launches > anib_launches:
        raise AssertionError(f"ANIb through the mesh made {launches} launches, phase 6 "
                             f"{anib_launches}")
    print(f"   ANIb through a mesh of the card named twice: {len(rows)} rows equal to phase 6's; "
          f"{launches} launches against {anib_launches}; wall s {seconds:.3f} ({smi})")

    anim_launches, anim_rows, anim_seconds = anim
    hook = work / "worker_hook"
    reports = work / "worker_reports"
    hook.mkdir()
    reports.mkdir()
    (hook / "sitecustomize.py").write_text(WORKER_SITE_HOOK)
    env = {"PYTHONPATH": os.pathsep.join([str(hook), str(Path(__file__).resolve().parent),
                                          *filter(None, [os.environ.get("PYTHONPATH")])]),
           "SMOKE_WORKER_REPORTS": str(reports)}  # fmt: skip
    saved = {key: os.environ.get(key) for key in env}
    t0 = phase("ANIm under launch -n 2: private databases, workers on the one card")
    os.environ.update(env)
    try:
        code = distributed.launch_local(
            2, ["anim", str(genomes), "-d", str(work / "run_{rank}.db"), "--create-db",
                "--log", str(work / "run_{rank}.log")],
            timeout=600, quiet=True,
        )  # fmt: skip
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    seconds = time.monotonic() - t0
    if code != 0:
        raise AssertionError(f"launch -n 2 anim exited {code}")
    host0 = comparison_rows(work / "run_0.db")
    host1 = comparison_rows(work / "run_1.db")
    if host0 != anim_rows:
        raise AssertionError("host 0's rows differ from phase 5's")
    if not 0 < len(host1) < len(anim_rows) or not set(host1) <= set(anim_rows):
        raise AssertionError(f"host 1's store holds {len(host1)} rows, not its share")
    for rank in range(2):
        log = (work / f"run_{rank}.log").read_text()
        if "cuda available: True" not in log or "capability: (9, 0)" not in log:
            raise AssertionError(f"worker {rank}'s log shows no probe of the card")
    workers = [json.loads(path.read_text()) for path in sorted(reports.iterdir())]
    if len(workers) != 2:
        raise AssertionError(f"{len(workers)} launch workers reported, not 2")
    for worker in workers:
        if worker["foreign"]:
            raise AssertionError(f"a launch worker imported {worker['foreign']}")
        if worker["device"] != "cuda:0" or not worker["extend_launches"]:
            raise AssertionError(f"a launch worker ran B1 {worker['extend_launches']} times "
                                 f"on {worker['device']}")
    print(f"   host 0: {len(host0)} rows equal to phase 5's; host 1: its share of {len(host1)} rows; "
          "both logs show the card probed at capability (9, 0); neither worker imported jax "
          "or pyani_plus_tpu")
    print("   extension kernel launches per worker, counted in the worker: "
          + ", ".join(f"{w['extend_launches']} on {w['device']}" for w in workers))
    print(f"   ANIm wall s: one process (phase 5) {anim_seconds:.3f}, launch -n 2 {seconds:.3f} "
          f"({smi})")
    done("launch", t0)


def build_kernels(_build) -> None:
    """Phase 2: one nvcc for each kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = phase("build")
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        list(pool.map(_build.load_library, KERNELS))
    for name in KERNELS:
        seconds, ptxas = _build.BUILD_INFO[name]
        print(f"   {name}: nvcc build seconds (set-up): {seconds:.3f}")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                print(f"   {name}: {line.strip()}")
    done("build", t0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA H100", file=sys.stderr)
        return 2
    from pyani_plus_tpu_torch import backend
    from pyani_plus_tpu_torch.ops import _build
    from pyani_plus_tpu_torch.ops import extend as ext
    from pyani_plus_tpu_torch.ops import minhash
    from pyani_plus_tpu_torch.ops import sw
    from pyani_plus_tpu_torch.parallel import runner
    from pyani_plus_tpu_torch.synthetic import write_alignment

    t0 = phase("probe")
    report = backend.probe()
    for line in report.lines():
        print(f"   {line}")
    if not report.kernels_supported:
        raise SystemExit(f"needs capability (9, 0), found {report.capability}")
    if not report.smi:
        raise SystemExit("nvidia-smi gave no name and power limit for the card")
    done("probe", t0)

    build_kernels(_build)
    timing = {"extend": check_kernel(torch, ext), "sw": check_sw_kernel(torch, sw)}

    logger = logging.getLogger("chip_smoke")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = phase(f"write {len(RATES)} genomes of {GENOME_LENGTH} bp and their alignment")
        paths, alignment = write_alignment(work / "genomes", GENOME_LENGTH, RATES, SEED)
        print(f"   alignment {alignment.name}: {alignment.stat().st_size} bytes")
        done("genomes", t0)
        anim = check_anim_path(ext, runner, logger, work, paths)
        anib = check_anib_path(sw, runner, logger, work, paths)
        launches = {"extend": anim[0], "sw": anib[0]}
        check_gram_fuzz(torch, minhash)
        gram_scale = check_gram_scale(torch, minhash)
        check_sourmash_path(minhash, runner, logger, work)
        check_host_methods((ext, sw), _build, runner, logger, work, alignment)
        check_split_paths(torch, minhash, sw, runner, logger, work, paths[0].parent,
                          gram_scale, anim, anib, report.smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t0 = phase("the port stands alone")
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "pyani_plus_tpu"))
    if foreign:
        raise AssertionError(f"the port imported {foreign[:5]}")
    print("   neither jax nor pyani_plus_tpu is in sys.modules")
    done("imports", t0)

    record = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches[name],
                **timing[name],
            }
            for name, (source, replaces) in KERNELS.items()
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
