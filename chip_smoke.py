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
   runner with the pair-grid mesh set to the card named twice, rows
   equal to phase 6's in more launches; ANIm under ``launch -n 2`` with
   private databases, host 0's rows equal to phase 5's, host 1 holding
   its share, both workers' logs showing the card, neither worker
   importing jax or the JAX package. On one card the times show what the
   split costs, not how it scales;
10. the entry points of ``graft_entry.py``: the Gram step of ``entry()`` on
    the card equal to the same call on the CPU, on seeded {0, 1} blocks;
    ``dryrun_multichip(4)`` over a 2 x 2 mesh that names the card four
    times (the containment, the merge, the alignment DP in 4 launches of
    the SW kernel, and a two-host ANIb run through the runner, which
    launches it too), its closing line printed; on a machine with several
    cards, the dry run again over all of them;
11. the device choice: with ``PYANI_TPU_TORCH_DEVICE=cpu`` set in this
    process, ANIm over one ordered pair of the genomes through the
    runner gives phase 5's row, launches no kernel and allocates no CUDA
    memory; with no card visible (``CUDA_VISIBLE_DEVICES=""``) and nothing
    requested, the CLI's ``anim`` refuses in a subprocess, alone and under
    ``launch -n 2``, within 60 s, its message naming the variable, and
    stores no comparison;
12. interrupt and resume on the card, for ANIm and then ANIb: 8 genomes
    of 800 kb (ANIm) or 200 kb (ANIb) from one ancestor at 1-5%
    substitutions (64 ordered pairs; an uninterrupted CLI run lasts over
    20 s) run once through the runner
    in this process for the reference rows; then the CLI in a subprocess,
    in an environment built without the device request and with every
    card visible, gets SIGTERM (ANIm, as SLURM sends it) or SIGINT (ANIb)
    5 s after its store says Running and its log names the card, and must
    exit within 60 s with code 0 (the JAX CLI's for both signals), no
    traceback or CUDA error in its output, the run "Worker interrupted"
    with some but not all rows, and its kernel launched on cuda:0 (counted
    in the process); ANIm's ``resume`` gets SIGINT the same way and must
    leave the run "Worker interrupted" with the rows it had, and not all;
    the last ``resume`` in a subprocess must reach Done with every row
    equal to the reference's;
13. the edge inputs on which the JAX package's fixture-gated tests pin
    its behaviour, re-based on synthetic genomes as the port's tests do:
    the coverage set (a 7,582 bp contig with a 28-N run, an 18,001 bp
    contig, and both as two records of one file), a null pair of
    unrelated 40 kb genomes, the N-run contig alone, and a divergent
    pair of two-contig genomes. ANIm, dnadiff, ANIb and sourmash run over
    each through the runner on the card and again with the CPU requested
    (the native host route): rows equal, the coverage by contig length,
    the NULL cross rows, the N run's identity, B1 launched by ANIm and
    dnadiff and B2 by ANIb, sourmash's Gram on the host at these sizes;
14. the profiler trace: ``PYANI_TPU_PROFILE`` set, ANIm and then ANIb over
    the coverage set and the contig pair in this process; each
    ``trace-<pid>.json`` loads and holds one CUDA kernel event of the
    kernel's name for each launch counted, rows equal to phase 13's;
15. the unit edges and a long trace: the edge inputs of the port's unit
    tests (``synthetic.extension_edge_tasks``: the named DP pairs, one-code,
    N-only and IUPAC tasks, the two fuzz sets, the four tasks around the
    JAX package's largest bucket of 10,240 columns, the band DP trials and
    gaps at a block's ends; ``synthetic.sw_edge_tasks``: the named pairs,
    the score-parity, IUPAC, trim-equivalence (bare and padded) and Pallas
    sets, ANIb's tail, all-N and padding fragments, a window as wide as
    the width rule's edge and a task at each side of it) through each
    kernel in one launch, tuples equal to the plain version's and the
    native oracle's; ``synthetic.gram_edge_sets`` (identical, disjoint,
    nested and empty sketches) through the Gram on the card, counts equal
    to the host's and the ANI matrices with NaN in the same places; then
    phase 5's ANIm over the 2 Mb genomes once more without and once with
    ``PYANI_TPU_PROFILE``: rows equal to phase 5's, one ``extend_kernel``
    event in the trace for each of the run's launches, the two walls and
    the trace's bytes printed;
16. neither ``jax`` nor the JAX package ``pyani_plus_tpu`` was imported.

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
import signal
import sqlite3
import subprocess
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


def packed_on_card(tasks: list[tuple[np.ndarray, np.ndarray]], order: np.ndarray | None = None):
    """``tasks`` packed as the kernels take them (in ``order``, when given)
    and copied to the card: the staging buffer and the six views there."""
    from pyani_plus_tpu_torch.ops._tasks import pack_tasks

    staging = pack_tasks(tasks, order)
    return staging, staging.views(staging.buf.cuda())


def check_kernel(torch, ext) -> dict:
    """Phase 3: the extension kernel against its plain version and the
    host oracle, its times, and the batch-size sweep."""
    from pyani_plus_tpu_torch.methods import anim
    from pyani_plus_tpu_torch.synthetic import extension_tasks
    from pyani_plus_tpu_torch.utils import intra_pair_workers

    rng = np.random.default_rng(SEED)
    tasks = fuzz_tasks(rng)
    wide = sum(not ext.uses_packed_fields(task) for task in tasks)
    t0 = phase(f"kernel vs plain: fuzz set of {len(tasks)} tasks "
               f"(longest {max(a.size for a, _ in tasks)} rows, {wide} with 32-bit fields)")
    if not 0 < wide < len(tasks):
        raise AssertionError("the fuzz set must hold tasks of both payload widths")
    got = ext.batch_extend(tasks, "cuda")
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

    tasks = extension_tasks(rng, 512)
    t0 = phase("kernel vs plain at the main path's shape: 512 tasks, "
               "1500-3200 rows, every 8th 9900 rows, 12% substitutions")
    order = ext.launch_order(tasks)
    staging, packed = packed_on_card(tasks, order)
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

    wrapper_ms = median_ms(lambda: ext.batch_extend(tasks, "cuda"), 5)
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
              **bound("extend", cells, staging.buf.numel() + out.numel() * 4)}
    # the same mix eight times over, 4,096 tasks: several warps share a
    # scheduler, so the card's rate shows and not one task's latency
    _, big = packed_on_card(tasks * 8, ext.launch_order(tasks * 8))
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
    one_ms = median_ms(lambda: ext.batch_extend(shares[0], "cuda"), 5)
    gate = threading.Barrier(4)

    def together(share):
        gate.wait()  # all four threads submit at once
        return ext.batch_extend(share, "cuda")

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
    share_views = [packed_on_card(s, ext.launch_order(s))[1] for s in shares]
    torch.cuda.synchronize()

    def four_kernels(side_by_side: bool) -> None:
        for stream, views in zip(streams, share_views):
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
            card_ms = median_ms(lambda: ext.batch_extend(batch, "cuda"), 5)
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
    got = sw.batch_sw_best(tasks, "cuda")
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
    staging, packed = packed_on_card(tasks)
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
    sw.batch_sw_best(tasks, "cuda")
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
    nbytes = staging.buf.numel() + out.numel() * 4
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
    _, big = packed_on_card(tasks, order)
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
    from pyani_plus_tpu_torch.utils import spans

    db = work / f"{tag}.db"
    host_env = {**host_env, **HOST_SHARE} if host_env else {}
    os.environ.update(host_env)
    kernel.reset_counts()
    t0 = phase(f"{method} {tag}: {'native host' if host_env else 'CUDA kernel'}")
    try:
        with spans.recording():
            runner.start_and_run_method(logger, db, fasta, method, create_db=True)
    finally:
        for key in host_env:
            os.environ.pop(key, None)
    launches, tasks = kernel.LAUNCHES, kernel.TASKS
    seconds = time.monotonic() - t0
    done(tag, t0)
    print(f"   kernel launches {launches}, tasks through the kernel {tasks}")
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
    from pyani_plus_tpu_torch.genomes import load_genome
    from pyani_plus_tpu_torch.synthetic import write_clade_dir
    from pyani_plus_tpu_torch.utils import spans

    rates = [float(r) for r in np.linspace(0.005, 0.05, CLADE_SIZE)]
    t0 = phase(f"write {CLADES} clades x {CLADE_SIZE} genomes of {CLADE_LENGTH} bp")
    paths = write_clade_dir(work / "clades", CLADE_LENGTH, CLADES, rates, SEED)
    done("clade genomes", t0)

    db = work / "sourmash.db"
    cache = work / "cache"
    minhash.reset_counts()
    spans.reset()
    t0 = phase(f"sourmash all-vs-all: {len(paths)} genomes through the port's runner")
    with spans.recording():
        runner.start_and_run_method(logger, db, paths[0].parent, "sourmash",
                                    create_db=True, cache=cache)
    launches = minhash.LAUNCHES
    done("sourmash run", t0)
    for name, total in spans.totals().items():  # the runner's, sourmash's and the Gram's stages
        print(f"   span {name}: {total.seconds:.3f} s, self {total.self_seconds:.3f} s "
              f"({total.count} spans)")
    print(f"   counters: {spans.counters()}")
    print(f"   device Gram calls on the card: {launches}")

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


# The launch workers' interpreters (and phase 12's CLI processes) refuse
# jax and the JAX package, and each writes down at exit which of them it
# holds, how many times it launched each kernel and which card was current.
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
    sw = sys.modules.get("pyani_plus_tpu_torch.ops.sw")
    backend = sys.modules.get("pyani_plus_tpu_torch.backend")
    report = {"foreign": loaded, "extend_launches": extend.LAUNCHES if extend else None,
              "sw_launches": sw.LAUNCHES if sw else None,
              "device": str(backend.kernel_device()) if backend else None}
    with open(os.path.join(os.environ["SMOKE_WORKER_REPORTS"], str(os.getpid())), "w") as out:
        out.write(json.dumps(report))
"""


def check_split_paths(torch, minhash, sw, runner, logger, work: Path, genomes: Path,
                      gram_scale: tuple, anim: tuple, anib: tuple, smi: str) -> None:
    """Phase 9: several processes and several devices, on the one card.

    (a) the Gram at N = 1,000 split over a 2 x 2 mesh that names the card
    four times; (b) the SW kernel's main shape split over the card named
    twice; (c) ANIb through the runner with the pair-grid mesh set to
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
    one = sw.batch_sw_best(tasks, card)
    before = sw.LAUNCHES
    halves = sw.batch_sw_best(tasks, [card, card])
    if sw.LAUNCHES != before + 2:
        raise AssertionError(f"the split SW made {sw.LAUNCHES - before} launches, not 2")
    if halves != one:
        raise AssertionError("the split SW differs from one launch")
    one_ms = median_ms(lambda: sw.batch_sw_best(tasks, card), 5)
    halves_ms = median_ms(lambda: sw.batch_sw_best(tasks, [card, card]), 5)
    print(f"   identical tuples on all {len(tasks)} tasks; wrapper ms incl. packing and copies "
          f"(host clock, median of 5): one launch {one_ms:.3f}, two slices {halves_ms:.3f} ({smi})")
    done("split SW", t0)

    anib_launches, anib_rows = anib
    with tiles.pair_mesh(tiles.make_mesh(devices=[card, card])):
        rows, launches, seconds = run_method(sw, runner, logger, work, genomes, "ANIb",
                                             "anib_mesh", host_env=None)
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


def check_graft_entry(torch, sw, smi: str) -> None:
    """Phase 10: the entry points of graft_entry.py on the card. The Gram
    step of `entry()` against the same call on the CPU (exact integers in
    float32), then `dryrun_multichip(4)` over a 2 x 2 mesh that names the
    card four times: the SW kernel's launch counts are zeroed just before it and
    read just after, per step from what the dry run returns."""
    import io

    from pyani_plus_tpu_torch import graft_entry

    card = torch.device("cuda", 0)
    t0 = phase("graft entry: the Gram step on the card, and the dry run over the card "
               "named four times")
    fn, args = graft_entry.entry()
    if any(a.device != card for a in args):
        raise AssertionError(f"entry()'s arguments are on {[str(a.device) for a in args]}")
    rng = np.random.default_rng(SEED + 10)
    rows, block = args[1].shape
    inputs = [rng.integers(0, 1 << 16, (rows, rows)).astype(np.float32),
              (rng.random((rows, block)) < 0.3).astype(np.int8),
              (rng.random((rows, block)) < 0.3).astype(np.int8)]  # fmt: skip
    on_card = fn(*(torch.from_numpy(x).to(card) for x in inputs)).cpu()
    on_cpu = fn(*(torch.from_numpy(x) for x in inputs))
    if not torch.equal(on_card, on_cpu):
        raise AssertionError("the Gram step on the card differs from the CPU")
    print(f"   Gram step {tuple(on_card.shape)} on the card == on the CPU, exactly")

    sw.reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        record = graft_entry.dryrun_multichip(4, devices=[card] * 4)
    launches = sw.LAUNCHES
    line = out.getvalue().strip().splitlines()[-1]
    print(f"   {line}")
    if not line.startswith("dryrun_multichip OK: mesh (2, 2) (4 devices)"):
        raise AssertionError("the dry run printed no closing line")
    steps = record["sw_launches"]
    if steps["alignment"] != 4 or not steps["runner"] > 0 or sum(steps.values()) != launches:
        raise AssertionError(f"SW kernel launches {steps}, {launches} in all; the alignment "
                             "step needs 4 and the runner more than 0")
    print(f"   SW kernel launches in the dry run: alignment step {steps['alignment']}, "
          f"runner step {steps['runner']} ({smi})")
    if torch.cuda.device_count() >= 2:
        graft_entry.dryrun_multichip(torch.cuda.device_count())
    print(f"   graft entry wall seconds: {time.monotonic() - t0:.3f} ({smi})", flush=True)


def check_device_choice(torch, ext, runner, logger, work: Path, anim_rows: list[tuple],
                        smi: str) -> None:
    """Phase 11: the caller's device choice on a card machine. (a) The CPU
    requested in this process: ANIm over one ordered pair through the
    runner (a share of the 2 x 2 grid that holds one pair of two genomes)
    on the native host kernels, its row equal to phase 5's, no extension
    launch, no CUDA allocation. (b) and (c) No card visible and nothing
    requested: the CLI refuses, alone and under ``launch -n 2``."""
    from pyani_plus_tpu_torch import backend

    pair = work / "pair"  # genome_0 and genome_1, written by phase 5
    share = {backend.ENV_DEVICE: "cpu", "PYANI_TPU_PROCESS_COUNT": "4",
             "PYANI_TPU_PROCESS_INDEX": "1"}  # fmt: skip
    t0 = phase("ANIm over one ordered pair with the CPU requested, on a card machine")
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ext.reset_counts()
    os.environ.update(share)
    try:
        runner.start_and_run_method(logger, work / "cpu_request.db", pair, "ANIm",
                                    create_db=True)  # fmt: skip
    finally:
        for key in share:
            os.environ.pop(key, None)
    seconds = time.monotonic() - t0
    rows = comparison_rows(work / "cpu_request.db")
    if ext.LAUNCHES:
        raise AssertionError(f"the CPU request launched the extension kernel {ext.LAUNCHES} times")
    if torch.cuda.memory_allocated() != allocated or torch.cuda.max_memory_allocated() != allocated:
        raise AssertionError("the CPU request allocated CUDA memory")

    def stems(row: tuple) -> tuple:
        return (Path(row[0]).stem, Path(row[1]).stem, *row[2:])

    if len(rows) != 1 or rows[0][0] == rows[0][1]:
        raise AssertionError(f"the CPU request stored {len(rows)} rows, not one ordered pair")
    if stems(rows[0]) not in {stems(row) for row in anim_rows}:
        raise AssertionError(f"the CPU request's row differs from phase 5's: {rows[0]}")
    print(f"   {Path(rows[0][0]).stem} vs {Path(rows[0][1]).stem}: the row equals phase 5's; "
          f"0 extension launches; CUDA memory allocated {allocated} bytes before and after, "
          f"peak {torch.cuda.max_memory_allocated()}")
    print(f"   CPU request wall s: {seconds:.3f} ({smi})")
    done("cpu request", t0)

    env = {key: value for key, value in os.environ.items() if key != backend.ENV_DEVICE}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = os.pathsep.join([str(Path(__file__).resolve().parent),
                                         *filter(None, [os.environ.get("PYTHONPATH")])])
    for tag, prefix in (("alone", []), ("launch -n 2", ["launch", "-n", "2", "--"])):
        db = f"refused_{len(prefix)}_{{rank}}.db" if prefix else "refused.db"
        t0 = phase(f"anim with no card visible and nothing requested: {tag}")
        proc = subprocess.run(
            [sys.executable, "-m", "pyani_plus_tpu_torch.cli.main", *prefix, "anim",
             str(pair), "-d", str(work / db), "--create-db"],
            capture_output=True, text=True, env=env, timeout=60, check=False,
        )  # fmt: skip
        seconds = time.monotonic() - t0
        stored = [work / db.format(rank=rank) for rank in range(2 if prefix else 1)]
        if proc.returncode in (0, 124):
            raise AssertionError(f"anim ({tag}) with no card exited {proc.returncode}")
        if "PYANI_TPU_TORCH_DEVICE=cpu" not in proc.stderr:
            raise AssertionError(f"anim ({tag}) refused without naming the variable: "
                                 f"{proc.stderr[-500:]}")
        if any(path.exists() and comparison_rows(path) for path in stored):
            raise AssertionError(f"anim ({tag}) with no card stored comparisons")
        print(f"   exit {proc.returncode}: {proc.stderr.strip().splitlines()[-1]}")
        print(f"   refusal ({tag}) wall s: {seconds:.3f} ({smi})")
        done(f"refusal {tag}", t0)


# Phase 12: eight genomes of one ancestor at 1-5% substitutions, 64
# ordered pairs. On an H100 at 250 kb an uninterrupted run through the
# runner took 23.8 and 45.6 s (ANIm; the host's clock varies between
# machines) and 15.2 and 18.2 s (ANIb), the CLI 9 s more to reach
# Running, and 7-12 rows were stored in the 5 s before the signal; at
# 500 kb ANIm took 48.7 s and stored one. At 200 kb ANIm took 17.5 s and
# ANIb 14.4 s, with 10 and 20 rows stored before the signal, and the
# phase 114 s. Since ANIm's faster chaining and seeding, ANIm takes 4.2 s
# at 200 kb and the CLI is Done before the signal, so ANIm's genomes are
# four times as long: at 800 kb ANIm took 11.8 s and stored 9 rows before
# the signal.
INTERRUPT_RATES = [0.01 + 0.04 * i / 7 for i in range(8)]
INTERRUPT_LENGTH = {"ANIm": 800_000, "ANIb": 200_000}
INTERRUPT_DELAY = 5.0  # seconds from "Running" and the card in the log to SIGINT
INTERRUPT_KERNEL = {"ANIm": ("B1", "extend_launches"), "ANIb": ("B2", "sw_launches")}
# SLURM stops a job with SIGTERM; a user at the terminal with SIGINT.
INTERRUPT_SIGNAL = {"ANIm": signal.SIGTERM, "ANIb": signal.SIGINT}
FAULTS = ("Traceback", "CUDA error", "cudaError", "CUDA_ERROR", "illegal memory access",
          "terminate called", "Segmentation fault", "core dumped")


def run_status(db: Path) -> str | None:
    try:
        with sqlite3.connect(db) as conn:
            row = conn.execute("SELECT status FROM runs").fetchone()
    except sqlite3.OperationalError:  # not created yet
        return None
    return row[0] if row else None


def cli_report(text: str, reports: Path, method: str, tag: str, code: int) -> dict:
    """The checks both of phase 12's CLI processes share: exit code 0 (the
    JAX CLI's after an interrupt too: its runner marks the run and
    returns), no fault in the output, the card in the log, and the
    process's own report (WORKER_SITE_HOOK): no foreign import, its kernel
    launched on cuda:0. Returns the report."""
    if code != 0:
        raise AssertionError(f"{method} {tag} exited {code}: {text[-1500:]}")
    faults = [fault for fault in FAULTS if fault in text]
    if faults:
        raise AssertionError(f"{method} {tag}: {faults} in its output: {text[-1500:]}")
    if f"{method} runs on cuda:" not in text:
        raise AssertionError(f"{method} {tag}: the log does not show the card")
    [report] = [json.loads(path.read_text()) for path in reports.iterdir()]
    launches = report[INTERRUPT_KERNEL[method][1]]
    if report["foreign"] or report["device"] != "cuda:0" or not launches:
        raise AssertionError(f"{method} {tag}: {report}")
    return report


def interrupt_cli(argv: list[str], method: str, db: Path, log: Path, reports: Path,
                  sig: signal.Signals, env: dict[str, str]) -> tuple[int, float, float]:
    """Start the port's CLI (``argv``) in a subprocess and send it `sig`
    ``INTERRUPT_DELAY`` s after its store says Running and its log names
    the card. Returns (exit code, seconds to Running, seconds from the
    signal to the exit)."""
    t0 = time.monotonic()
    reports.mkdir()
    with log.open("w") as out:
        proc = subprocess.Popen(argv, cwd=Path(__file__).resolve().parent,
                                env={**env, "SMOKE_WORKER_REPORTS": str(reports)}, stdout=out,
                                stderr=subprocess.STDOUT)  # fmt: skip
    try:
        deadline = time.monotonic() + 120
        while not (run_status(db) == "Running" and f"{method} runs on cuda:" in log.read_text()):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"{method} never ran on the card: {log.read_text()[-1500:]}")
            time.sleep(0.05)
        running = time.monotonic() - t0
        time.sleep(INTERRUPT_DELAY)
        if proc.poll() is not None:
            raise AssertionError(f"{method} ended before the signal: make it longer")
        signalled = time.monotonic()
        proc.send_signal(sig)
        code = proc.wait(timeout=60)
        return code, running, time.monotonic() - signalled
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def check_interrupt_resume(kernels, runner, logger, work: Path, smi: str) -> None:
    """Phase 12: a signal to the port's CLI on the card, then ``resume``,
    for ANIm (pair threads launching B1 on their own streams) and ANIb (up
    to three B2 launches queued, side threads waiting on their events).
    For each method: an uninterrupted run through the runner in this
    process gives the reference rows; the CLI in a subprocess (an
    environment built here: no device request, every card visible) is
    sent SIGTERM (ANIm, as SLURM sends it) or SIGINT (ANIb)
    ``INTERRUPT_DELAY`` s after its store says Running and its log names
    the card; it must exit 0 (the JAX CLI's code for both signals) within
    60 s, no fault in its output, the run "Worker interrupted" with some
    but not all rows, and its kernel launched. ANIm's ``resume`` is sent
    SIGINT the same way and must leave the run "Worker interrupted" with
    the rows it had, and not all; the last ``resume`` must reach Done with
    every row equal to the reference's."""
    from pyani_plus_tpu_torch.synthetic import write_genome_dir

    hook = work / "interrupt_hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(WORKER_SITE_HOOK)
    root = Path(__file__).resolve().parent
    env = {key: value for key, value in os.environ.items()
           if not key.startswith("PYANI_TPU") and key != "CUDA_VISIBLE_DEVICES"}  # fmt: skip
    env["PYTHONPATH"] = os.pathsep.join([str(hook), str(root),
                                         *filter(None, [os.environ.get("PYTHONPATH")])])
    cli = [sys.executable, "-m", "pyani_plus_tpu_torch.cli.main"]
    n_pairs = len(INTERRUPT_RATES) ** 2
    for (method, command), kernel in zip((("ANIm", "anim"), ("ANIb", "anib")), kernels):
        name, key = INTERRUPT_KERNEL[method]
        sig = INTERRUPT_SIGNAL[method]
        genomes = work / f"interrupt_genomes_{command}"
        write_genome_dir(genomes, INTERRUPT_LENGTH[method], INTERRUPT_RATES, SEED)
        reference, launches, seconds = run_method(kernel, runner, logger, work, genomes, method,
                                                  f"{command}_uninterrupted", host_env=None)
        if len(reference) != n_pairs or not launches:
            raise AssertionError(f"{method} uninterrupted: {len(reference)} rows, "
                                 f"{launches} launches")
        print(f"   {method} uninterrupted: {len(INTERRUPT_RATES)} genomes of "
              f"{INTERRUPT_LENGTH[method]} bp, {n_pairs} rows in {seconds:.3f} s ({smi})")

        db, tag = work / f"{command}_interrupted.db", f"{command}_interrupted"
        t0 = phase(f"{method} CLI on the card, {sig.name} {INTERRUPT_DELAY} s after Running")
        code, running, exit_seconds = interrupt_cli(
            [*cli, command, str(genomes), "-d", str(db), "--create-db"], method, db,
            work / f"{tag}.log", work / f"{tag}_reports", sig, env)  # fmt: skip
        report = cli_report((work / f"{tag}.log").read_text(), work / f"{tag}_reports", method,
                            "interrupted", code)  # fmt: skip
        status, partial = run_status(db), comparison_rows(db)
        if status != "Worker interrupted" or not 0 < len(partial) < n_pairs:
            raise AssertionError(f"{method} interrupted: status {status!r}, {len(partial)} rows")
        if not set(partial) <= set(reference):
            raise AssertionError(f"{method} interrupted: a stored row differs from the reference")
        print(f"   {method}: Running and the card after {running:.3f} s; exit {code} "
              f"{exit_seconds:.3f} s after {sig.name}; status {status!r}; {len(partial)} of "
              f"{n_pairs} rows stored; {name} launches in the process "
              f"{report[key]} ({smi})")
        done(f"{command} interrupted", t0)

        if method == "ANIm":
            tag = f"{command}_resume_interrupted"
            t0 = phase(f"{method} resume on the card, SIGINT {INTERRUPT_DELAY} s after Running")
            code, running, exit_seconds = interrupt_cli(
                [*cli, "resume", "-d", str(db)], method, db, work / f"{tag}.log",
                work / f"{tag}_reports", signal.SIGINT, env)  # fmt: skip
            report = cli_report((work / f"{tag}.log").read_text(), work / f"{tag}_reports",
                                method, "resume interrupted", code)  # fmt: skip
            status, rows = run_status(db), comparison_rows(db)
            if status != "Worker interrupted" or not len(partial) <= len(rows) < n_pairs:
                raise AssertionError(f"{method} resume interrupted: status {status!r}, "
                                     f"{len(rows)} rows after {len(partial)}")
            if not set(partial) <= set(rows) <= set(reference):
                raise AssertionError(f"{method} resume interrupted: a row was lost or differs "
                                     "from the reference")
            print(f"   {method} resume: Running and the card after {running:.3f} s; exit {code} "
                  f"{exit_seconds:.3f} s after SIGINT; status {status!r}; {len(rows)} of "
                  f"{n_pairs} rows stored ({len(partial)} before); {name} launches in the "
                  f"process {report[key]} ({smi})")
            done(f"{command} resume interrupted", t0)

        reports = work / f"{command}_resumed_reports"
        reports.mkdir()
        t0 = phase(f"{method} resume on the card")
        proc = subprocess.run(
            [*cli, "resume", "-d", str(db)], cwd=root, capture_output=True, text=True,
            env={**env, "SMOKE_WORKER_REPORTS": str(reports)}, timeout=600, check=False,
        )  # fmt: skip
        report = cli_report(proc.stdout + proc.stderr, reports, method, "resume",
                            proc.returncode)
        status, rows = run_status(db), comparison_rows(db)
        if status != "Done" or rows != reference:
            raise AssertionError(f"{method} resumed: status {status!r}, {len(rows)} rows, "
                                 f"equal to the reference: {rows == reference}")
        print(f"   {method} resumed: Done, {len(rows)} rows equal to the uninterrupted run's "
              f"(ints exact, floats ==); {name} launches in the process "
              f"{report[key]} ({smi})")
        done(f"{command} resume", t0)


# Phase 13: the inputs on which the JAX package's end-to-end behaviour is
# pinned by its fixture-gated tests, re-based on synthetic genomes with the
# seeds of the port's tests that hold it to the JAX package on the CPU
# (tests/test_torch_coverage_semantics.py, test_torch_bad_alignments_e2e.py,
# test_torch_self_vs_self.py): multi-contig coverage, NULL cross rows, an
# N run, and a divergent pair of two-contig genomes whose alignment blocks
# end short of the contig ends (the coverage set's contigs align end to
# end or not at all, the null pair not at all, so only this pair leaves
# ANIm and dnadiff tails to extend).
EDGE_METHODS = ("ANIm", "dnadiff", "ANIb", "sourmash")
EDGE_KERNEL = {"ANIm": "B1", "dnadiff": "B1", "ANIb": "B2"}
N_RUN_LENGTH = 7582  # the reference's N-run contig; ANIm scores it 1 - 28/7,582
N_RUN_ANIM_IDENTITY = 0.9963070429965708


def write_edge_inputs(root: Path) -> dict[str, Path]:
    """The coverage set, the null pair, the N-run genome (alone: its self
    pair) and the divergent contig pair, each in a directory of its own."""
    from pyani_plus_tpu_torch import synthetic

    synthetic.write_coverage_set(root / "coverage", seed=1)
    synthetic.write_null_pair(root / "null_pair", 40_000, seed=2)
    (root / "n_run").mkdir()
    synthetic.write_n_run_genome(root / "n_run" / "n_run.fasta", N_RUN_LENGTH, seed=3)
    synthetic.write_contig_pair(root / "contigs", seed=4)
    return {name: root / name for name in ("coverage", "null_pair", "n_run", "contigs")}


def edge_run(counters: dict, runner, logger, work: Path, fasta: Path, method: str,
             tag: str) -> tuple[list[tuple], dict[str, int]]:
    """One run through the port's runner with every launch count zeroed
    just before it. Returns (rows, launches by counter)."""
    for module in counters.values():
        module.reset_counts()
    db = work / f"{tag}.db"
    runner.start_and_run_method(logger, db, fasta, method, create_db=True, cache=work / f"{tag}_cache")
    return comparison_rows(db), {name: module.LAUNCHES for name, module in counters.items()}


def check_edge_rows(name: str, method: str, rows: list[tuple]) -> None:
    """The JAX cases' assertions on one input's rows, each row
    (query, subject, identity, aln_length, sim_errors, cov_query,
    cov_subject)."""
    from pyani_plus_tpu_torch.synthetic import COVERAGE_CONTIGS

    by = {(Path(q).stem, Path(s).stem): tuple(rest) for q, s, *rest in rows}
    null = (None,) * 5
    fault = f"{method} on the {name} input: {by}"
    if name == "coverage":
        if len(by) != 9 or by["small", "large"] != null or by["large", "small"] != null:
            raise AssertionError(fault)
        if method != "sourmash":  # alignment coverage by contig length; sourmash's is k-mers
            small, large = COVERAGE_CONTIGS["small"], COVERAGE_CONTIGS["large"]
            want = {("both", "small"): small / (small + large),
                    ("both", "large"): large / (small + large)}  # fmt: skip
            for key, row in by.items():
                if row != null and abs(row[3] - want.get(key, 1.0)) > 5e-10:
                    raise AssertionError(fault)
    elif name == "null_pair":
        cross = [row for (q, s), row in by.items() if q != s]
        if len(by) != 4 or cross != [null, null]:
            raise AssertionError(fault)
        if not all(row[0] > 0.99 for (q, s), row in by.items() if q == s):
            raise AssertionError(fault)
    elif name == "n_run":
        [row] = by.values()
        if method == "ANIm" and abs(row[0] - N_RUN_ANIM_IDENTITY) > 1e-12:
            raise AssertionError(fault)
        if method != "ANIm" and row[0] != 1.0:
            raise AssertionError(fault)
    elif name == "contigs":  # sourmash's cross rows: at scaled 1,000 these 6.5 kb share little
        for (q, s), row in by.items():
            if (q == s and row[0] != 1.0) or (q != s and method != "sourmash"
                                              and not 0.9 < row[0] < 1.0):  # fmt: skip
                raise AssertionError(fault)


def check_edge_inputs(counters: dict, runner, logger, work: Path, smi: str) -> dict:
    """Phase 13: ANIm, dnadiff, ANIb and sourmash over each edge input
    through the port's runner on the card, and again with the CPU
    requested in this process (the native host route); rows equal (ints
    exact, floats ==), the JAX cases' assertions met, B1 launched by ANIm
    and dnadiff and B2 by ANIb; sourmash's Gram stays on the host at these
    sizes. Returns the card's rows by (method, input)."""
    from pyani_plus_tpu_torch import backend
    from pyani_plus_tpu_torch.ops.minhash import Sketch

    t0 = phase("edge inputs: the coverage set, the null pair, the N-run genome, the contig pair")
    inputs = write_edge_inputs(work / "edge")
    rows: dict[tuple[str, str], list[tuple]] = {}
    for method in EDGE_METHODS:
        totals = dict.fromkeys(counters, 0)
        for name, fasta in inputs.items():
            t1 = time.monotonic()
            card, launches = edge_run(counters, runner, logger, work, fasta, method,
                                      f"edge_{method}_{name}_card")  # fmt: skip
            card_seconds = time.monotonic() - t1
            os.environ[backend.ENV_DEVICE] = "cpu"
            try:
                t1 = time.monotonic()
                host, host_launches = edge_run(counters, runner, logger, work, fasta, method,
                                               f"edge_{method}_{name}_host")  # fmt: skip
                host_seconds = time.monotonic() - t1
            finally:
                os.environ.pop(backend.ENV_DEVICE)
            if card != host:
                raise AssertionError(f"{method} on the {name} input: card rows {card} != host "
                                     f"rows {host}")
            if any(host_launches.values()):
                raise AssertionError(f"{method} on the {name} input: the host route launched "
                                     f"{host_launches}")
            check_edge_rows(name, method, card)
            rows[method, name] = card
            for key, count in launches.items():
                totals[key] += count
            print(f"   {method} {name}: {len(card)} rows, card == host route (ints exact, "
                  f"floats ==); launches {launches}; s card {card_seconds:.3f}, host "
                  f"{host_seconds:.3f}")
        kernel = EDGE_KERNEL.get(method)
        if kernel and not totals[kernel]:
            raise AssertionError(f"{method} never launched {kernel} on the edge inputs")
        if method == "sourmash":
            if totals["Gram"]:
                raise AssertionError(f"sourmash launched the device Gram {totals['Gram']} times")
            sketches = {path.name: path for path in
                        work.glob("edge_sourmash_*_card_cache/sourmash_k=31_scaled=1000/*.npy")}  # fmt: skip
            hashes = sum(Sketch("", 31, 1000, np.load(path)).num_hashes for path in sketches.values())
            print(f"   sourmash: at most 3 genomes an input and {hashes} hashes in all (below "
                  f"2^18): the Gram takes the host route, no launch claimed")
    seconds = time.monotonic() - t0
    print(f"   phase 13 wall s: {seconds:.3f} ({smi})")
    done("edge inputs", t0)
    return rows


def check_profiler_trace(counters: dict, runner, logger, work: Path, edge_rows: dict,
                         smi: str) -> None:
    """Phase 14: ``PYANI_TPU_PROFILE`` on the card. ANIm and then ANIb over
    the coverage set and the contig pair through the runner in this
    process, each into a directory of its own: ``trace-<pid>.json`` must
    load as JSON and hold one CUDA kernel event whose name contains the
    kernel's symbol for each launch its wrapper counted, in all more than
    none; rows equal to phase 13's."""
    inputs = {"coverage": work / "edge" / "coverage", "contigs": work / "edge" / "contigs"}
    for method, kernel, symbol in (("ANIm", "B1", "extend_kernel"), ("ANIb", "B2", "sw_kernel")):
        seen = 0
        for name, fasta in inputs.items():
            trace_dir = work / f"trace_{method}_{name}"
            t0 = phase(f"{method} over the {name} input under the profiler")
            os.environ["PYANI_TPU_PROFILE"] = str(trace_dir)
            try:
                rows, launches = edge_run(counters, runner, logger, work, fasta, method,
                                          f"trace_{method}_{name}")  # fmt: skip
            finally:
                os.environ.pop("PYANI_TPU_PROFILE")
            seconds = time.monotonic() - t0
            trace = trace_dir / f"trace-{os.getpid()}.json"
            events = json.loads(trace.read_text())["traceEvents"]
            kinds = sorted({event.get("cat", "") for event in events})
            found = [event for event in events
                     if event.get("cat") == "kernel" and symbol in event.get("name", "")]  # fmt: skip
            if len(found) != launches[kernel]:
                raise AssertionError(f"{method} {name}: {len(found)} {symbol} events in the trace, "
                                     f"{launches[kernel]} launches; categories {kinds}")
            if rows != edge_rows[method, name]:
                raise AssertionError(f"{method} {name}: rows under the profiler differ from phase 13's")
            seen += len(found)
            print(f"   {trace.name}: {trace.stat().st_size} bytes, {len(events)} events, "
                  f"{len(found)} {symbol} kernel events == {launches[kernel]} {kernel} launches; "
                  f"rows equal to phase 13's; s {seconds:.3f} ({smi})")
            done(f"{method} {name} traced", t0)
        if not seen:
            raise AssertionError(f"{method}: no {symbol} event in any trace")


def by_group(groups: dict[str, list], results: list) -> dict[str, list]:
    """Results of the groups' tasks, taken in order, split by group."""
    out, start = {}, 0
    for name, tasks in groups.items():
        out[name] = results[start : start + len(tasks)]
        start += len(tasks)
    return out


def check_unit_edges(torch, ext, sw, minhash, smi: str) -> dict[str, dict[str, int]]:
    """Phase 15a: the unit tests' edge inputs through B1, B2 and the Gram
    on the card. Each kernel takes its tasks in one launch (counted apart
    from the main path's), tuples equal to the plain version's and the
    native oracle's; the Gram's counts equal the host's, its ANI matrices
    the host route's (NaN in the same places). Returns each kernel's
    launches and tasks."""
    from pyani_plus_tpu_torch import synthetic

    workers = os.cpu_count() or 1
    record = {}
    kernels = (
        ("extend", ext, synthetic.extension_edge_tasks(SEED + 5), ext.batch_extend,
         ext.batch_extend_reference, lambda tasks: ext.batch_extend_host(tasks, workers=workers)),
        ("sw", sw, synthetic.sw_edge_tasks(SEED + 6, rule_edge=True), sw.batch_sw_best,
         sw.batch_sw_best_reference, lambda tasks: sw.batch_sw_best_host(tasks, workers=workers)),
    )  # fmt: skip
    for name, module, groups, kernel, plain_fn, host_fn in kernels:
        tasks = [task for group in groups.values() for task in group]
        t0 = phase(f"unit edges through {name}: {len(tasks)} tasks in {len(groups)} groups "
                   f"({', '.join(f'{g} {len(v)}' for g, v in groups.items())}), longest "
                   f"{max(max(a.size, b.size) for a, b in tasks)}")  # fmt: skip
        launches, count = module.LAUNCHES, module.TASKS
        got = kernel(tasks, "cuda")
        torch.cuda.synchronize()
        launches, count = module.LAUNCHES - launches, module.TASKS - count
        t1 = time.monotonic()
        plain = plain_fn(tasks)
        plain_seconds = time.monotonic() - t1
        host = host_fn(tasks)
        split = [by_group(groups, results) for results in (got, plain, host)]
        bad = [f"{group}[{i}]: {rows}" for group in groups
               for i, rows in enumerate(zip(*(s[group] for s in split))) if len(set(rows)) > 1]  # fmt: skip
        if bad:
            raise AssertionError(f"{name} disagrees on {len(bad)} unit edge tasks: {bad[:3]}")
        if launches != 1 or count != len(tasks):
            raise AssertionError(f"{name}: {launches} launches, {count} tasks; expected 1 and {len(tasks)}")
        if name == "extend":
            oversize = [r for (a, _b), r in zip(groups["oversize"], split[0]["oversize"])
                        if a.size > synthetic.EXTEND_BUCKET_LIMIT]  # fmt: skip
            far = max(r[0] for r in oversize)
            if len(oversize) != 2 or far <= synthetic.EXTEND_BUCKET_LIMIT:
                raise AssertionError(f"the oversize tasks did not extend past the bucket: {oversize}")
            print(f"   the {len(oversize)} tasks past {synthetic.EXTEND_BUCKET_LIMIT} columns in the "
                  f"one launch; the longer extends {far} rows")
        else:
            packed = sum(sw.uses_packed_lanes(a.size, b.size) for a, b in tasks)
            if not 0 < packed < len(tasks):
                raise AssertionError("the SW unit edges must hold tasks of both widths")
            print(f"   {packed} tasks in packed 16-bit lanes, {len(tasks) - packed} in 32-bit words")
        print(f"   identical tuples: kernel == plain == native on {len(tasks)} tasks; "
              f"{launches} launch, {count} tasks; plain s {plain_seconds:.3f} ({smi})")
        record[name] = {"unit_edge_launches": launches, "unit_edge_tasks": count}
        done(f"{name} unit edges", t0)

    sets = synthetic.gram_edge_sets()
    t0 = phase(f"unit edges through the Gram: {', '.join(sets)}")
    launches = minhash.LAUNCHES
    for name, sketches in sets.items():
        host = minhash.intersection_matrix_host(sketches)
        card = minhash.intersection_matrix_device(sketches, device="cuda")
        if not np.array_equal(card, host):
            raise AssertionError(f"Gram {name}: card {card.tolist()} != host {host.tolist()}")
        for x, y in zip(minhash.containment_ani(sketches, use_device=True),
                        minhash.containment_ani(sketches, use_device=False)):  # fmt: skip
            if not np.array_equal(x, y, equal_nan=True):
                raise AssertionError(f"Gram {name}: card ANI {x.tolist()} != host {y.tolist()}")
        print(f"   {name}: counts {card.tolist()} == host; ANI == host route (NaN where NaN)")
    launches = minhash.LAUNCHES - launches
    if launches != 2 * len(sets):
        raise AssertionError(f"the Gram ran {launches} times on the card, expected {2 * len(sets)}")
    done("Gram unit edges", t0)
    return record


def check_long_trace(ext, runner, logger, work: Path, genomes: Path,
                     anim_rows: list[tuple], anim_launches: int, smi: str) -> None:
    """Phase 15b: the trace's cost on a long run. Phase 5's ANIm over the
    2 Mb genomes, once without and then once with ``PYANI_TPU_PROFILE``,
    the card equally warm for both: rows equal to phase 5's, as many
    launches, and one ``extend_kernel`` kernel event in the trace for each
    launch."""
    rows, launches, untraced = run_method(ext, runner, logger, work, genomes, "ANIm",
                                          "anim_untraced", host_env=None)  # fmt: skip
    if rows != anim_rows or launches != anim_launches:
        raise AssertionError(f"ANIm again: {launches} launches, rows equal {rows == anim_rows}")
    trace_dir = work / "trace_anim_2mb"
    os.environ["PYANI_TPU_PROFILE"] = str(trace_dir)
    try:
        rows, launches, traced = run_method(ext, runner, logger, work, genomes, "ANIm",
                                            "anim_traced", host_env=None)  # fmt: skip
    finally:
        os.environ.pop("PYANI_TPU_PROFILE")
    t0 = phase("ANIm's 2 Mb trace")
    trace = trace_dir / f"trace-{os.getpid()}.json"
    size = trace.stat().st_size
    events = json.loads(trace.read_text())["traceEvents"]
    found = [event for event in events
             if event.get("cat") == "kernel" and "extend_kernel" in event.get("name", "")]  # fmt: skip
    if rows != anim_rows:
        raise AssertionError("ANIm under the profiler: rows differ from phase 5's")
    if not len(found) == launches == anim_launches:
        raise AssertionError(f"ANIm under the profiler: {len(found)} extend_kernel events, "
                             f"{launches} launches, phase 5 {anim_launches}")
    kernel_us = sum(event.get("dur", 0) for event in found)
    print(f"   {trace.name}: {size} bytes, {len(events)} events, {len(found)} extend_kernel "
          f"events == {launches} B1 launches (their durations {kernel_us / 1e3:.3f} ms); "
          f"rows equal to phase 5's")
    print(f"   ANIm 3 x 2 Mb wall s: untraced {untraced:.3f}, traced {traced:.3f} "
          f"({traced / untraced:.3f} x) ({smi})")
    done("2 Mb trace", t0)


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
        check_graft_entry(torch, sw, report.smi)
        check_device_choice(torch, ext, runner, logger, work, anim[1], report.smi)
        check_interrupt_resume((ext, sw), runner, logger, work, report.smi)
        counters = {"B1": ext, "B2": sw, "Gram": minhash}
        edge_rows = check_edge_inputs(counters, runner, logger, work, report.smi)
        check_profiler_trace(counters, runner, logger, work, edge_rows, report.smi)
        unit_edges = check_unit_edges(torch, ext, sw, minhash, report.smi)
        check_long_trace(ext, runner, logger, work, paths[0].parent, anim[1], anim[0], report.smi)
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
                **unit_edges[name],
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
