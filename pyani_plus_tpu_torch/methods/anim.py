"""ANIm: whole-genome alignment ANI, with the extensions on the card.

Port of ``pyani_plus_tpu/methods/anim.py``. Seeding, clustering,
chaining, gap fills, the 1-to-1 filter and scoring are the JAX package's
own JAX-free code, imported as they are; this module owns only the call
chain that reached the Pallas kernel there: ``align_sequences`` ->
``_run_extensions`` -> the batched free-end extensions, which go to the
CUDA kernel (``ops/extend.py``) when CUDA is present and the batch holds
at least ``EXT_BATCH_MIN_CUDA`` tasks, and to the native host kernel
otherwise. Both are exact to the integer, so the rows are the JAX
package's rows.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pyani_plus_tpu import native
from pyani_plus_tpu.genomes import Genome, complement_codes
from pyani_plus_tpu.methods.anim import (
    EXT_BAND,
    EXT_BATCH_MIN,
    EXT_BREAKLEN,
    MIN_MATCH,
    MODE,
    NAME,
    PROGRAM,
    _assemble_alignment,
    _chain_and_fill,
    _extension_tasks,
    configuration,
    score_alignments,
)
from pyani_plus_tpu.ops.chaining import Alignment, cluster_matches, one_to_one
from pyani_plus_tpu.ops.extend import EXTEND, MATCH, MISMATCH, OPEN, extend_errors
from pyani_plus_tpu.ops.suffix import (
    SEED_CACHE,
    max_matches_indexed,
    maximal_matches,
    mum_matches_indexed,
    seed_index_enabled,
)
from pyani_plus_tpu.utils import intra_pair_workers
from pyani_plus_tpu_torch import backend
from pyani_plus_tpu_torch.methods import ComputeContext, run_pairwise
from pyani_plus_tpu_torch.ops.extend import BAND, batch_extend

__all__ = [
    "MODE",
    "NAME",
    "PROGRAM",
    "align_sequences",
    "compute",
    "compute_pair",
    "configuration",
]

if EXT_BAND != BAND:  # pragma: no cover - the kernel's layout fixes the band
    msg = f"the extension kernel is laid out for band {BAND}, ANIm uses {EXT_BAND}"
    raise ImportError(msg)

# Default minimum batch for the CUDA extension kernel when a card is
# present, carried over from the JAX package's TPU threshold; to be
# re-chosen from card measurements. Without CUDA the native host kernel
# runs (EXT_BATCH_MIN). PYANI_TPU_EXTEND_BATCH_MIN overrides either, with
# the JAX package's meaning (small values force the batched path, which
# on a CPU-only host is the plain PyTorch version).
EXT_BATCH_MIN_CUDA = 64


def load_native_libraries() -> None:
    """Build and load the path's native host libraries in this thread.

    The JAX package's loaders mark a library as tried before they build
    it, so a pair thread that asks while another thread builds gets no
    library and its caller takes the slower numpy route (for seeding,
    ``seed_index_enabled`` keeps that answer for the whole process). On
    a checkout with no library built yet, the pair pool would race into
    that; loading here first keeps every pair on the native routes.
    """
    empty = np.zeros(0, np.int64)
    native.suffix_array_native(np.zeros(1, np.int64))
    native.band_dp_native(
        np.zeros(1, np.uint8), np.zeros(1, np.uint8), BAND, True,
        MATCH, MISMATCH, OPEN, EXTEND,
    )  # fmt: skip
    native.cluster_roots_native(empty, empty, empty, 1, 1, 0.0)
    seed_index_enabled()


def _default_ext_batch_min() -> int:
    return EXT_BATCH_MIN_CUDA if backend.probe().cuda else EXT_BATCH_MIN


def _run_extensions(
    tasks: list[tuple[np.ndarray, np.ndarray]],
) -> list[tuple[int, int, int, int, int]]:
    """Batch free-end extensions: the CUDA kernel when CUDA is present and
    the batch is large, per-task native kernel otherwise. Exact either way."""
    device_idx: list[int] = []
    device_tasks: list[tuple[np.ndarray, np.ndarray]] = []
    results: list[tuple[int, int, int, int, int] | None] = [None] * len(tasks)
    env_min = os.environ.get("PYANI_TPU_EXTEND_BATCH_MIN")
    min_batch = int(env_min) if env_min else _default_ext_batch_min()
    for idx, (a, b) in enumerate(tasks):
        if a.size and b.size:
            # extend_errors' pre-trim; only full-band tasks batch (shorter
            # ones shrink the band below EXT_BAND, extend.py:285)
            limit = min(a.size, b.size) + EXT_BREAKLEN
            a_t, b_t = a[:limit], b[:limit]
            if max(a_t.size, b_t.size) >= EXT_BAND:
                device_idx.append(idx)
                device_tasks.append((a_t, b_t))
    if len(device_tasks) >= min_batch:
        for idx, res in zip(
            device_idx,
            batch_extend(
                device_tasks,
                backend.kernel_device(),
                stop_rows=3 * EXT_BREAKLEN,
            ),
        ):
            results[idx] = res
    host_idx = [idx for idx in range(len(tasks)) if results[idx] is None]
    # The native band-DP kernel releases the GIL inside ctypes, so the
    # remaining extensions run thread-parallel across host cores.
    workers = intra_pair_workers()
    if workers > 1 and len(host_idx) > 4:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for idx, res in zip(
                host_idx,
                pool.map(lambda i: extend_errors(*tasks[i]), host_idx),
            ):
                results[idx] = res
    else:
        for idx in host_idx:
            results[idx] = extend_errors(*tasks[idx])
    return results  # type: ignore[return-value]


def align_sequences(
    ref: np.ndarray,
    qry: np.ndarray,
    *,
    mode: str = "mum",
    min_match: int = MIN_MATCH,
) -> list[Alignment]:
    """All alignment blocks between one ref and one qry sequence."""
    unique = mode == "mum"
    qlen = qry.size
    use_index = seed_index_enabled()

    def _strand(reverse: bool):
        if reverse:
            q_codes = (
                SEED_CACHE.rc_for(qry)
                if use_index
                else complement_codes(qry)[::-1].copy()
            )
        else:
            q_codes = qry
        if use_index and unique:
            r, q, ln = mum_matches_indexed(
                SEED_CACHE.sam_for(ref), ref, q_codes, min_match
            )
        elif use_index:
            r, q, ln = max_matches_indexed(
                SEED_CACHE.sam_for(ref), ref, q_codes, min_match
            )
        else:
            r, q, ln = maximal_matches(
                ref, q_codes, min_match, unique_ref=unique, unique_qry=unique
            )
        return q_codes, [
            (reverse, r[idx], q[idx], ln[idx])
            for idx in cluster_matches(r, q, ln)
        ]

    strand_workers = min(2, intra_pair_workers())
    if strand_workers > 1:
        with ThreadPoolExecutor(max_workers=strand_workers) as pool:
            per_strand = list(pool.map(_strand, (False, True)))
    else:
        per_strand = [_strand(False), _strand(True)]
    strand_matches = {rev: per_strand[rev][0] for rev in (False, True)}
    clusters = [cl for _codes, cls in per_strand for cl in cls]

    workers = intra_pair_workers()
    if workers > 1 and len(clusters) > 4:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            fills = list(
                pool.map(
                    lambda c: _chain_and_fill(
                        ref, strand_matches[c[0]], c[1], c[2], c[3]
                    ),
                    clusters,
                )
            )
    else:
        fills = [
            _chain_and_fill(ref, strand_matches[rev], r, q, ln)
            for rev, r, q, ln in clusters
        ]

    # Outward extensions of every chained cluster, batched together so
    # that the kernel runs them all in one launch.
    tasks: list[tuple[np.ndarray, np.ndarray]] = []
    task_of: list[int | None] = []
    for (reverse, _r, _q, _ln), fill in zip(clusters, fills):
        if fill is None:
            task_of.append(None)
            continue
        task_of.append(len(tasks))
        tasks.extend(_extension_tasks(fill, ref, strand_matches[reverse]))
    ext_results = _run_extensions(tasks)

    alignments: list[Alignment] = []
    for (reverse, _r, _q, _ln), fill, base in zip(clusters, fills, task_of):
        if fill is None or base is None:
            continue
        block = _assemble_alignment(
            fill, ext_results[base], ext_results[base + 1]
        )
        if reverse:
            qs, qe = block.qry_start, block.qry_end
            block = Alignment(
                ref_start=block.ref_start,
                ref_end=block.ref_end,
                qry_start=qlen - qe,
                qry_end=qlen - qs,
                errors=block.errors,
                reverse=True,
                gap_columns=block.gap_columns,
                nonid=block.nonid,
            )
        alignments.append(block)
    return alignments


def compute_pair(query: Genome, subject: Genome, mode: str = "mum") -> dict:
    """One directed comparison: subject is the nucmer reference."""
    all_blocks: list[Alignment] = []
    keys: list[tuple[int, int]] = []
    for si, s_rec in enumerate(subject.records):
        for qi, q_rec in enumerate(query.records):
            blocks = align_sequences(s_rec.codes, q_rec.codes, mode=mode)
            all_blocks.extend(blocks)
            keys.extend([(si, qi)] * len(blocks))
    # delta-filter -1 with per-sequence-per-axis chains (grouping keys)
    kept = set(id(a) for a in one_to_one(all_blocks, keys))
    per_seq: dict[tuple[int, int], list[Alignment]] = {}
    for key, block in zip(keys, all_blocks):
        if id(block) in kept:
            per_seq.setdefault(key, []).append(block)
    query_aligned, ref_aligned, identity, sim_errors = score_alignments(per_seq)
    return {
        "identity": identity,
        "aln_length": query_aligned,
        "sim_errors": sim_errors,
        "cov_query": None
        if query_aligned is None
        else float(query_aligned) / query.length,
        "cov_subject": None
        if ref_aligned is None
        else float(ref_aligned) / subject.length,
    }


def compute(ctx: ComputeContext) -> list[dict]:
    load_native_libraries()
    mode = ctx.config.get("mode") or MODE
    return run_pairwise(
        ctx,
        lambda q, s: compute_pair(ctx.genomes[q], ctx.genomes[s], mode),
    )
