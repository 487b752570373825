"""ANIm: whole-genome alignment ANI, with the extensions on the card.

Port of ``pyani_plus_tpu/methods/anim.py`` (nucmer ``--mum`` +
``delta-filter -1`` equivalent):

1. maximal unique matches (length >= 20) on both strands through a
   suffix automaton of the reference (``ops/suffix.py``); ``--maxmatch``
   drops the uniqueness requirement (dnadiff);
2. mgaps-style clustering (``ops/chaining.py``);
3. per cluster: consistent anchor chain, banded DP over inter-anchor
   gaps (``ops/extend_host.py``), banded free-end extension outward from
   the terminal anchors;
4. delta-filter -1 analogue: intersection of the best ref-axis and
   qry-axis chains;
5. scoring: identity = sum((ref_len + qry_len) - 2*sim) / sum(ref_len +
   qry_len), aligned bases per genome by interval union, coverage =
   aligned bases / genome length; no alignments -> all None.

Every stage but one is numpy and C++ on the host, as in the JAX package.
The call chain that reached the Pallas kernel there, ``align_sequences``
-> ``_run_extensions`` -> the batched free-end extensions, goes to the
CUDA kernel (``ops/extend.py``) when the work goes to the card and the
batch holds at least ``EXT_BATCH_MIN_CUDA`` tasks, and to the native host
kernel otherwise (the CPU requested with ``PYANI_TPU_TORCH_DEVICE=cpu``,
or a batch below ``PYANI_TPU_EXTEND_BATCH_MIN``). Both are exact to the integer, so the rows are the JAX
package's rows.

The stages carry spans (``utils/spans.py``), each with its ordered pair:
``anim.pair`` over ``compute_pair``, and within it ``anim.seed`` and
``anim.cluster`` on each strand's thread, ``anim.chain`` (chaining and gap
fills, one native call a cluster, with the counter ``anim.native_gaps`` of
the gaps it filled), ``anim.extend`` (the extension tasks and their host
part; B1's wait is ``extend.wait`` within it) and ``anim.filter`` (the
1-to-1 filter and the scoring).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pyani_plus_tpu_torch import __version__, backend, native
from pyani_plus_tpu_torch.genomes import Genome, complement_codes
from pyani_plus_tpu_torch.methods import ComputeContext, run_pairwise
from pyani_plus_tpu_torch.ops.chaining import Alignment, cluster_matches, one_to_one
from pyani_plus_tpu_torch.ops.extend import (
    BAND,
    batch_extend_collect,
    batch_extend_submit,
)
from pyani_plus_tpu_torch.ops.extend_host import (
    EXTEND,
    MATCH,
    MISMATCH,
    OPEN,
    extend_errors,
    gap_errors,
)
from pyani_plus_tpu_torch.ops.suffix import (
    SEED_CACHE,
    max_matches_indexed,
    maximal_matches,
    mum_matches_indexed,
    seed_index_enabled,
)
from pyani_plus_tpu_torch.utils import intra_pair_workers, spans

__all__ = [
    "MODE",
    "NAME",
    "PROGRAM",
    "align_sequences",
    "compute",
    "compute_pair",
    "configuration",
]

NAME = "ANIm"
PROGRAM = "pyani-plus-tpu-anim"

MIN_MATCH = 20  # nucmer -l default
MODE = "mum"


def configuration(*, mode: str = MODE) -> dict:
    return {
        "method": NAME,
        "program": PROGRAM,
        "version": __version__,
        "mode": mode,
    }


def _consistent_chain(
    r: np.ndarray, q: np.ndarray, ln: np.ndarray
) -> list[tuple[int, int, int]]:
    """Longest consistent (both axes increasing) anchor chain by weight."""
    order = np.argsort(r, kind="stable")
    anchors = [(int(r[i]), int(q[i]), int(ln[i])) for i in order]
    n = len(anchors)

    dp = native.anchor_chain_dp_native(r[order], q[order], ln[order])
    if dp is not None:
        best, prev = dp
    else:  # pragma: no cover - no compiler
        best = [0.0] * n
        prev = [-1] * n
        for i in range(n):
            ri, qi, li = anchors[i]
            best[i] = float(li)
            for j in range(i):
                rj, qj, lj = anchors[j]
                if (
                    rj <= ri
                    and qj <= qi
                    and rj + lj <= ri + li
                    and qj + lj <= qi + li
                ):
                    cand = best[j] + li
                    if cand > best[i]:
                        best[i] = cand
                        prev[i] = j
    end = int(np.argmax(best))
    chain = []
    while end != -1:
        chain.append(anchors[end])
        end = prev[end]
    return chain[::-1]


MAX_EXTENSION = 9999  # postnuc caps outward extension length (fitted
# against the reference .delta fixtures: both extensions of the rotated
# viral pair stop at exactly 9999 bases past the terminal anchors)


def _chain_and_fill(
    ref: np.ndarray,
    qry: np.ndarray,
    r: np.ndarray,
    q: np.ndarray,
    ln: np.ndarray,
) -> tuple[int, int, int, int, int, int] | None:
    """Chain one cluster and fill inter-anchor gaps (host phase).

    Returns (errors, nonid, gapcols, rs, qs, prev_re, prev_qe); the
    outward extensions happen separately so they can batch onto the
    device. One native call does it all outside the interpreter lock
    (``native/band.cpp``: ``chain_and_fill``), counted by the gaps it
    filled (``anim.native_gaps``); the Python below is its no-compiler
    fallback and parity oracle.
    """
    done = native.chain_and_fill_native(
        ref, qry, r, q, ln, MATCH, MISMATCH, OPEN, EXTEND
    )
    if done is not None:
        fill, gaps = done
        spans.count("anim.native_gaps", gaps)
        return fill
    chain = _consistent_chain(r, q, ln)
    if not chain:
        return None
    errors = 0
    nonid = 0
    gapcols = 0
    rs, qs, l0 = chain[0]
    prev_re, prev_qe = rs + l0, qs + l0
    for ri, qi, li in chain[1:]:
        # Trim anchor start to remove overlap with the previous anchor
        trim = max(prev_re - ri, prev_qe - qi, 0)
        ri_t, qi_t = ri + trim, qi + trim
        if trim >= li:
            # Anchor fully inside the previous coverage: advancing the
            # frontier here would let the next gap fill skip bases that
            # never got alignment columns (undercounting errors vs the
            # single-path alignment nucmer emits), so drop it outright.
            continue
        g_err, g_nid, g_gap = gap_errors(ref[prev_re:ri_t], qry[prev_qe:qi_t])
        errors += g_err
        nonid += g_nid
        gapcols += g_gap
        prev_re, prev_qe = ri + li, qi + li
    return errors, nonid, gapcols, rs, qs, prev_re, prev_qe


EXT_BAND = 60  # extend_errors' band; the kernel's lanes share it
EXT_BREAKLEN = 200
# Smallest batch that goes to the CUDA extension kernel when the work
# goes to the card (backend.on_card). On the H100 the wrapper (pack, one
# copy, launch, copy back, event) beat the native host kernel, run as
# _run_extensions runs it, at every batch size from one task up, for
# tails of 150-700 rows and for ANIm's long tails alike (chip_smoke.py's
# sweep; PERF.md has the measurements), so every full-band task goes to
# the card. With the CPU
# requested (PYANI_TPU_TORCH_DEVICE=cpu) the native host kernel runs
# (EXT_BATCH_MIN).
# PYANI_TPU_EXTEND_BATCH_MIN overrides either, with the JAX package's
# meaning (small values force the batched path, which on the requested
# CPU is the plain PyTorch version, and without the card it raises).
EXT_BATCH_MIN_CUDA = 1
EXT_BATCH_MIN = 1 << 30  # the CPU: host kernel

if EXT_BAND != BAND:  # pragma: no cover - the kernel's layout fixes the band
    msg = f"the extension kernel is laid out for band {BAND}, ANIm uses {EXT_BAND}"
    raise ImportError(msg)


def _default_ext_batch_min() -> int:
    return EXT_BATCH_MIN_CUDA if backend.on_card() else EXT_BATCH_MIN


def _extension_tasks(
    fill: tuple[int, int, int, int, int, int, int],
    ref: np.ndarray,
    qry: np.ndarray,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """The two outward-extension (a, b) tail pairs of one chained cluster."""
    _err, _nid, _gap, rs, qs, prev_re, prev_qe = fill
    left_budget = min(rs, MAX_EXTENSION)
    right_budget = min(ref.size - prev_re, MAX_EXTENSION)
    return [
        (
            ref[rs - left_budget : rs][::-1].copy(),
            qry[max(0, qs - MAX_EXTENSION) : qs][::-1].copy(),
        ),
        (
            ref[prev_re : prev_re + right_budget].copy(),
            qry[prev_qe : prev_qe + MAX_EXTENSION].copy(),
        ),
    ]


def _run_extensions(
    tasks: list[tuple[np.ndarray, np.ndarray]],
) -> list[tuple[int, int, int, int, int]]:
    """Batch free-end extensions: the CUDA kernel when the work goes to the
    card and the batch is large, per-task native kernel otherwise. Exact either way.

    The batch is submitted first and collected last, so the tasks that
    stay on the host (empty or shorter than the band) run while the card
    works."""
    device_idx: list[int] = []
    device_tasks: list[tuple[np.ndarray, np.ndarray]] = []
    results: list[tuple[int, int, int, int, int] | None] = [None] * len(tasks)
    env_min = os.environ.get("PYANI_TPU_EXTEND_BATCH_MIN")
    min_batch = int(env_min) if env_min else _default_ext_batch_min()
    for idx, (a, b) in enumerate(tasks):
        if a.size and b.size:
            # extend_errors' pre-trim; only full-band tasks batch (shorter
            # ones shrink the band below EXT_BAND in extend_errors)
            limit = min(a.size, b.size) + EXT_BREAKLEN
            a_t, b_t = a[:limit], b[:limit]
            if max(a_t.size, b_t.size) >= EXT_BAND:
                device_idx.append(idx)
                device_tasks.append((a_t, b_t))
    submitted = None
    if len(device_tasks) >= min_batch:
        submitted = batch_extend_submit(
            device_tasks, backend.kernel_device(), stop_rows=3 * EXT_BREAKLEN
        )
        host_idx = sorted(set(range(len(tasks))) - set(device_idx))
    else:
        host_idx = list(range(len(tasks)))
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
    if submitted is not None:
        for idx, res in zip(device_idx, batch_extend_collect(submitted)):
            results[idx] = res
    return results  # type: ignore[return-value]


def _assemble_alignment(
    fill: tuple[int, int, int, int, int, int, int],
    ext_left: tuple[int, int, int, int, int],
    ext_right: tuple[int, int, int, int, int],
) -> Alignment:
    errors, nonid, gapcols, rs, qs, prev_re, prev_qe = fill
    ext_l_r, ext_l_q, ext_l_err, ext_l_nid, ext_l_gap = ext_left
    ext_r_r, ext_r_q, ext_r_err, ext_r_nid, ext_r_gap = ext_right
    return Alignment(
        ref_start=rs - ext_l_r,
        ref_end=prev_re + ext_r_r,
        qry_start=qs - ext_l_q,
        qry_end=prev_qe + ext_r_q,
        errors=errors + ext_l_err + ext_r_err,
        gap_columns=gapcols + ext_l_gap + ext_r_gap,
        nonid=nonid + ext_l_nid + ext_r_nid,
    )


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
    caller = spans.current()  # the parent of the strand threads' spans

    def _strand(reverse: bool):
        if reverse:
            q_codes = (
                SEED_CACHE.rc_for(qry)
                if use_index
                else complement_codes(qry)[::-1].copy()
            )
        else:
            q_codes = qry
        with spans.span("anim.seed", parent=caller):
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
        with spans.span("anim.cluster", parent=caller):
            found = cluster_matches(r, q, ln)
        return q_codes, [(reverse, r[idx], q[idx], ln[idx]) for idx in found]

    strand_workers = min(2, intra_pair_workers())
    if strand_workers > 1:
        with ThreadPoolExecutor(max_workers=strand_workers) as pool:
            per_strand = list(pool.map(_strand, (False, True)))
    else:
        per_strand = [_strand(False), _strand(True)]
    strand_matches = {rev: per_strand[rev][0] for rev in (False, True)}
    clusters = [cl for _codes, cls in per_strand for cl in cls]

    workers = intra_pair_workers()
    with spans.span("anim.chain"):
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
    with spans.span("anim.extend"):
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
    with spans.span("anim.pair", request=(query.md5, subject.md5)):
        return _compare(query, subject, mode)


def _compare(query: Genome, subject: Genome, mode: str) -> dict:
    all_blocks: list[Alignment] = []
    keys: list[tuple[int, int]] = []
    for si, s_rec in enumerate(subject.records):
        for qi, q_rec in enumerate(query.records):
            blocks = align_sequences(s_rec.codes, q_rec.codes, mode=mode)
            all_blocks.extend(blocks)
            keys.extend([(si, qi)] * len(blocks))
    with spans.span("anim.filter"):
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


def _interval_union(intervals: list[tuple[int, int]]) -> int:
    """Total bases covered by inclusive-coordinate intervals (anim.py:53-69)."""
    if not intervals:
        return 0
    intervals = sorted(intervals)
    total = 0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            total += cur_e - cur_s + 1
            cur_s, cur_e = s, e
    total += cur_e - cur_s + 1
    return total


def score_alignments(
    per_seq_alignments: dict[tuple[int, int], list[Alignment]],
) -> tuple[int | None, int | None, float | None, int | None]:
    """parse_delta math: (query_aligned, ref_aligned, identity, sim_errors)."""
    sum_lengths = 0
    sum_penalty = 0
    sim_total = 0
    qry_regions: dict[int, list[tuple[int, int]]] = {}
    ref_regions: dict[int, list[tuple[int, int]]] = {}
    for (ref_id, qry_id), blocks in per_seq_alignments.items():
        for a in blocks:
            ref_len = a.ref_end - a.ref_start  # == inclusive |e-s|+1
            qry_len = a.qry_end - a.qry_start
            sum_lengths += ref_len + qry_len
            sum_penalty += 2 * a.errors
            sim_total += a.errors
            ref_regions.setdefault(ref_id, []).append(
                (a.ref_start + 1, a.ref_end)
            )
            qry_regions.setdefault(qry_id, []).append(
                (a.qry_start + 1, a.qry_end)
            )
    if not sum_lengths:
        return None, None, None, None
    identity = (sum_lengths - sum_penalty) / sum_lengths
    query_aligned = sum(_interval_union(v) for v in qry_regions.values())
    ref_aligned = sum(_interval_union(v) for v in ref_regions.values())
    return query_aligned, ref_aligned, identity, sim_total


def compute(ctx: ComputeContext) -> list[dict]:
    mode = ctx.config.get("mode") or MODE
    return run_pairwise(
        ctx,
        lambda q, s: compute_pair(ctx.genomes[q], ctx.genomes[s], mode),
    )
