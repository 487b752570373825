"""ANIb: fragment + BLAST-equivalent alignment ANI, with the scoring on the card.

Port of ``pyani_plus_tpu/methods/anib.py``. Fragmenting, candidate
enumeration, the host scorer, the winner stats DP and the accept rules
are the JAX package's own JAX-free code, imported as they are; this
module owns only what reached JAX there: the choice of scorer
(``use_device``), the batched device scoring (``_score_device_submit`` /
``_score_device_collect``) and the call chain around them
(``compute_pair``, ``compute``). Device scoring goes to the CUDA kernel
(``ops/sw.py``) when CUDA is present and to the plain PyTorch version on
a CPU-only host; both return the score and the winning cell exactly, so
the rows are the JAX package's rows.

Against the JAX package's device path: one launch per pooled group, at
any window width (no bucket ladder, no padding, no host scoring of
windows over 32,768 columns), and always with the winning cell, so
``PYANI_TPU_ANIB_PALLAS`` and ``PYANI_TPU_ANIB_BATCH`` have no meaning
here.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pyani_plus_tpu import native
from pyani_plus_tpu.genomes import Genome
from pyani_plus_tpu.methods.anib import (
    FRAGSIZE,
    NAME,
    PROGRAM,
    _pair_finalize,
    _pair_tasks,
    _score_host,
    configuration,
)
from pyani_plus_tpu.ops.dp import GAP_EXTEND, GAP_OPEN, PENALTY, REWARD
from pyani_plus_tpu.ops.seeds import SeedIndex
from pyani_plus_tpu.utils import devmeter
from pyani_plus_tpu_torch import backend
from pyani_plus_tpu_torch.methods import ComputeContext
from pyani_plus_tpu_torch.ops.sw import batch_sw_best, pack_tasks, sw_cuda

__all__ = [
    "FRAGSIZE",
    "NAME",
    "PROGRAM",
    "compute",
    "compute_pair",
    "configuration",
    "use_device",
]

Pair = tuple[np.ndarray, np.ndarray]


def load_native_libraries() -> None:
    """Build and load ANIb's native host libraries in this thread.

    The JAX package's loaders mark a library as tried before they build
    it, so a pool thread that asks while another thread builds gets no
    library and its caller silently takes the numpy route: the stats DP
    and the host scorer (``libalign``) about 300 times slower, the seed
    join (``libseedjoin``) in numpy. On a checkout with no library built
    yet, the scoring and winner-stats pools would race into that;
    loading here first keeps every task on the native routes.
    """
    one = np.zeros(1, np.uint8)
    native.local_align_score_native(one, one, REWARD, PENALTY, GAP_OPEN, GAP_EXTEND)
    native.local_align_stats_native(one, one, REWARD, PENALTY, GAP_OPEN, GAP_EXTEND)
    empty = np.zeros(0, np.int64)
    native.seed_sort_rows_native(empty, empty.copy(), empty.copy())


def use_device() -> bool:
    """Batched device scoring: on when CUDA is present. The JAX package's
    ``PYANI_TPU_ANIB_DEVICE`` overrides it with the same meaning; ``1``
    on a CPU-only host runs the plain PyTorch version."""
    flag = os.environ.get("PYANI_TPU_ANIB_DEVICE")
    if flag in ("0", "1"):
        return flag == "1"
    return backend.probe().cuda


def _score_device_submit(pairs: list[Pair]):
    """Start scoring every candidate pair in one batch; returns the state
    for :func:`_score_device_collect`.

    On the card this packs the tasks into page-locked memory, copies them
    over, launches the kernel and queues the copy of the results back,
    all without waiting: host work for other groups overlaps the card's.
    On the CPU the plain version scores them here.
    """
    device = backend.kernel_device()
    t_submit = devmeter.now()
    if device.type != "cuda":
        return batch_sw_best(pairs, device), None, t_submit
    packed = [
        t.to(device, non_blocking=True) for t in pack_tasks(pairs, pin_memory=True)
    ]
    out = torch.empty((len(pairs), 3), dtype=torch.int32, pin_memory=True)
    out.copy_(sw_cuda(*packed), non_blocking=True)
    arrived = torch.cuda.Event()
    arrived.record()
    return out, arrived, t_submit


def _score_device_collect(state) -> tuple[list[int], list[tuple[int, int]]]:
    """Wait for a submitted batch: (scores, trims) per pair, where
    ``trims[i]`` is the winning (best_i, best_j) cell."""
    out, arrived, t_submit = state
    if arrived is not None:
        arrived.synchronize()
        out = out.tolist()
    devmeter.record(t_submit)
    return [row[0] for row in out], [(row[1], row[2]) for row in out]


def _score_device(pairs: list[Pair]):
    """Score all candidate (fragment, window) pairs on the device (blocking)."""
    return _score_device_collect(_score_device_submit(pairs))


def compute_pair(
    query: Genome,
    subject: Genome,
    seed_indexes: list[SeedIndex],
    fragsize: int,
) -> tuple[float | None, int | None, int | None]:
    """(identity, aln_length, sim_errors) for one directed pair."""
    on_device = use_device()
    frags, per_frag, flat, spans = _pair_tasks(
        query, subject, seed_indexes, fragsize, include_singles=on_device
    )
    if not flat:
        flat_scores, flat_trims = [], []
    elif on_device:
        flat_scores, flat_trims = _score_device(flat)
    else:
        flat_scores = _score_host(flat)
        flat_trims = [None] * len(flat)
    return _pair_finalize(
        query, subject, frags, per_frag, spans, flat_scores, flat_trims
    )


def compute(ctx: ComputeContext) -> list[dict]:
    load_native_libraries()
    fragsize = ctx.config.get("fragsize") or FRAGSIZE
    rows: list[dict] = []
    subjects = sorted({s for _q, s in ctx.pending})
    try:
        _compute_all(ctx, rows, subjects, fragsize)
    except KeyboardInterrupt:
        ctx.interrupted = True
        ctx.logger.error("Interrupted with %d completed comparisons", len(rows))
    return rows


def _compute_all(ctx, rows, subjects, fragsize):  # noqa: C901
    # The subject seed index is built once per column. With the device,
    # score tasks from groups of queries pool into one launch, and the
    # loop runs a lookahead pipeline: group g's launch is queued, then
    # earlier groups' host stages (winner stats, accept/accumulate) run
    # on side threads WHILE the main thread enumerates candidates for
    # the next group, so per-pair wall time is ~max(host, device).
    group_env = os.environ.get("PYANI_TPU_ANIB_GROUP")
    on_device = use_device()
    group_size = max(1, int(group_env) if group_env else (4 if on_device else 1))

    def group_results(subject, batch, tasks, offsets, pooled_scores,
                      pooled_trims=None):
        """Winner stats for a group (pure compute; safe off-thread)."""
        out = []
        for query_hash, (frags, per_frag, flat, spans), off in zip(
            batch, tasks, offsets
        ):
            out.append(
                (
                    query_hash,
                    _pair_finalize(
                        ctx.genomes[query_hash],
                        subject,
                        frags,
                        per_frag,
                        spans,
                        pooled_scores[off : off + len(flat)],
                        None
                        if pooled_trims is None
                        else pooled_trims[off : off + len(flat)],
                    ),
                )
            )
        return subject, out

    def emit(subject, results):
        """Rows + progress + flush, always on the compute thread (the
        flush callback may hold a thread-affine sqlite connection)."""
        for query_hash, (identity, aln_length, sim_errors) in results:
            query = ctx.genomes[query_hash]
            rows.append(
                {
                    "query_hash": query_hash,
                    "subject_hash": subject.md5,
                    "identity": identity,
                    "aln_length": aln_length,
                    "sim_errors": sim_errors,
                    "cov_query": None
                    if aln_length is None
                    else aln_length / query.length,
                    "cov_subject": None
                    if aln_length is None
                    else aln_length / subject.length,
                }
            )
            ctx.tick()
            ctx.maybe_flush(rows)

    def side_task(subject, batch, tasks, offsets, state):
        pooled_scores, pooled_trims = _score_device_collect(state)
        return group_results(
            subject, batch, tasks, offsets, pooled_scores, pooled_trims
        )

    # Side threads wait for the device results and run the winner-stats
    # DPs (which release the GIL) for earlier groups; results drain FIFO
    # on this thread, keeping row order deterministic and the store
    # callback thread-affine. In-flight depth = side workers + 1.
    side_workers = int(os.environ.get("PYANI_TPU_ANIB_SIDE", "2"))
    depth = side_workers + 1
    inflight: deque = deque()
    side = ThreadPoolExecutor(max_workers=side_workers)
    try:
        for subject_hash in subjects:
            subject = ctx.genomes[subject_hash]
            seed_indexes = [SeedIndex(rec.codes) for rec in subject.records]
            queries = sorted(q for q, s in ctx.pending if s == subject_hash)
            for lo in range(0, len(queries), group_size):
                batch = queries[lo : lo + group_size]
                tasks = [
                    _pair_tasks(
                        ctx.genomes[q], subject, seed_indexes, fragsize,
                        include_singles=on_device,
                    )
                    for q in batch
                ]
                pooled: list[Pair] = []
                offsets = []
                for _frags, _per_frag, flat, _spans in tasks:
                    offsets.append(len(pooled))
                    pooled.extend(flat)
                if on_device and pooled:
                    state = _score_device_submit(pooled)
                    while inflight and inflight[0].done():
                        emit(*inflight.popleft().result())
                    while len(inflight) >= depth:
                        emit(*inflight.popleft().result())
                    inflight.append(
                        side.submit(side_task, subject, batch, tasks,
                                    offsets, state)
                    )
                else:
                    while inflight:
                        emit(*inflight.popleft().result())
                    scores = _score_host(pooled) if pooled else []
                    emit(*group_results(subject, batch, tasks, offsets, scores))
        while inflight:
            emit(*inflight.popleft().result())
    finally:
        side.shutdown(wait=False, cancel_futures=True)
