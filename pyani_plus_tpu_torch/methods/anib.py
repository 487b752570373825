"""ANIb: fragment + BLAST-equivalent alignment ANI, with the scoring on the card.

Port of ``pyani_plus_tpu/methods/anib.py`` (Goris et al. 2007; blastn
scoring: reward 2, penalty -3, gap 5/2, evalue 1e-15). Per (query,
subject) pair:

1. chop every query sequence into <= 1020 bp pieces, tail included;
2. per fragment, find the best local alignment against the subject:
   11-mer seed hash-join -> candidate diagonal bands (both strands) ->
   windowed Smith-Waterman with blastn scoring; E-value gate at 1e-15
   via Karlin-Altschul (gapped 2/-3/5/2 parameters);
3. accept fragments with (length-gaps)/qlen > 0.7 and
   (length-gaps-mismatch)/qlen > 0.3;
4. identity = mean(pident)/100 with pident rounded to 3 decimals as
   blastn prints it; aln_length = sum(length-gaps);
   sim_errors = sum(mismatch+gaps); cov = aln_length / genome length.

Fragmenting, candidate enumeration, the host scorer, the winner stats DP
and the accept rules are numpy and C++ on the host, as in the JAX
package. What reached JAX there is the port's own: the choice of scorer
(``use_device``), the batched device scoring (``_score_device_submit`` /
``_score_device_collect``) and the call chain around them. Device
scoring goes to the CUDA kernel (``ops/sw.py``) when CUDA is present and
to the plain PyTorch version on a CPU-only host; both return the score
and the winning cell exactly, so the rows are the JAX package's rows.

Against the JAX package's device path: one launch per pooled group (one
a device when the pair-grid mesh splits the group over several cards,
as ``dp_jax._dispatch_sharded`` splits it), at any window width (no
bucket ladder, no padding, no host scoring of wide windows), and always
with the winning cell, so ``PYANI_TPU_ANIB_PALLAS`` and
``PYANI_TPU_ANIB_BATCH`` have no meaning here.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from math import log

import numpy as np

from pyani_plus_tpu_torch import __version__, backend, native
from pyani_plus_tpu_torch.genomes import Genome, complement_codes
from pyani_plus_tpu_torch.methods import ComputeContext
from pyani_plus_tpu_torch.ops.dp import (
    GAP_EXTEND,
    GAP_OPEN,
    PENALTY,
    REWARD,
    AlignmentStats,
    local_align_stats,
)
from pyani_plus_tpu_torch.ops.seeds import (
    SeedIndex,
    bands_from_sorted_diags,
    candidate_bands,
    pack_kmers,
)
from pyani_plus_tpu_torch.ops.sw import batch_sw_best_collect, batch_sw_best_submit
from pyani_plus_tpu_torch.utils import devmeter, intra_pair_workers

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

NAME = "ANIb"
PROGRAM = "pyani-plus-tpu-anib"

FRAGSIZE = 1020  # ref anib.py:40
MIN_COVERAGE = 0.7
MIN_IDENTITY = 0.3
EVALUE = 1e-15
# Karlin-Altschul parameters for gapped blastn 2/-3, gap 5/2
KA_LAMBDA = 0.625
KA_K = 0.41

WINDOW_MARGIN = 150  # subject window slack around the seed band

# The reference runs blastn with -xdrop_gap_final 150 (bits;
# private_cli.py:1393-1394), i.e. the REPORTED alignment comes from the
# final-pass extension with raw X-drop 150*ln2/lambda ~ 166 at lambda
# 0.625. A run of L Ns dips 3L raw, so runs up to 55 Ns are crossed in
# the final alignment (and count as IDENTITIES: blastn counts letter
# equality, so pident stays 100.000 across them -- the reference's
# test_coverage.py pins a 28-N fragment at full coverage AND pident
# 100); runs of >= 56 exceed the final X-drop and split the HSP.
N_BREAK_RUN = 56


def split_at_n_runs(
    codes: np.ndarray, min_run: int = N_BREAK_RUN
) -> list[tuple[int, np.ndarray]]:
    """(offset, piece) segments of codes split at non-ACGT runs >= min_run.

    >>> import numpy as np
    >>> codes = np.array([0, 1, 4, 4, 4, 2, 3], dtype=np.uint8)
    >>> [(int(off), piece.tolist()) for off, piece in split_at_n_runs(codes, 3)]
    [(0, [0, 1]), (5, [2, 3])]
    >>> [(off, len(p)) for off, p in split_at_n_runs(codes, 4)]
    [(0, 7)]
    """
    invalid = codes >= 4
    if not invalid.any():
        return [(0, codes)]
    # Run-length scan over the invalid mask.
    edges = np.flatnonzero(np.diff(invalid.astype(np.int8)))
    starts = np.concatenate(([0], edges + 1))
    ends = np.concatenate((edges + 1, [codes.size]))
    pieces: list[tuple[int, np.ndarray]] = []
    seg_start = 0
    for s, e in zip(starts, ends):
        if invalid[s] and e - s >= min_run:
            if s > seg_start:
                pieces.append((seg_start, codes[seg_start:s]))
            seg_start = e
    if codes.size > seg_start:
        pieces.append((seg_start, codes[seg_start:]))
    return pieces


def configuration(*, fragsize: int = FRAGSIZE) -> dict:
    return {
        "method": NAME,
        "program": PROGRAM,
        "version": __version__,
        "fragsize": fragsize,
    }


def fragment_genome(genome: Genome, fragsize: int) -> list[np.ndarray]:
    """Code-array fragments of <=fragsize, tails included (anib.py:58-88)."""
    fragments: list[np.ndarray] = []
    for rec in genome.records:
        for start in range(0, len(rec.codes), fragsize):
            fragments.append(rec.codes[start : start + fragsize])
    return fragments


@lru_cache(maxsize=4096)
def _min_score(qlen: int, subject_total: int, evalue: float = EVALUE) -> float:
    """Karlin-Altschul score threshold for the E-value cutoff.

    Memoised: per column only a handful of (qlen, subject_total) pairs
    occur but the threshold is consulted per fragment."""
    search_space = max(qlen * subject_total, 1)
    return log(KA_K * search_space / evalue) / KA_LAMBDA


def fragment_candidates(
    frag: np.ndarray,
    subject_records: list[np.ndarray],
    seed_indexes: list[SeedIndex],
) -> list[tuple[np.ndarray, np.ndarray, int]]:
    """Candidate (strand_frag, window, w_lo) alignments of one fragment."""
    frag_rc = complement_codes(frag)[::-1].copy()
    candidates = []
    for codes, index in zip(subject_records, seed_indexes):
        for strand_frag in (frag, frag_rc):
            q_pos, s_pos = index.hits(strand_frag)
            for diag_lo, diag_hi, _count in candidate_bands(q_pos, s_pos):
                w_lo = max(0, diag_lo - WINDOW_MARGIN)
                w_hi = min(
                    codes.size, diag_hi + strand_frag.size + WINDOW_MARGIN
                )
                # Long-N runs are uncrossable for blastn (see N_BREAK_RUN):
                # enumerate the split pieces so the SW picks the best HSP
                # on either side, never a merged one.
                for _f_off, f_piece in split_at_n_runs(strand_frag):
                    for w_off, w_piece in split_at_n_runs(codes[w_lo:w_hi]):
                        candidates.append((f_piece, w_piece, w_lo + w_off))
    return candidates


def _record_strand_diags(
    rec_codes: np.ndarray,
    index: SeedIndex,
    fragsize: int,
) -> tuple[dict[int, np.ndarray], dict[int, np.ndarray]]:
    """Per-fragment sorted seed diagonals for one query record vs one
    subject record, both strands, from ONE hash join per strand.

    Returns (plus, minus): maps fragment-ordinal (within this record) ->
    sorted diag array (subject_pos - within-fragment query pos). The
    per-fragment k-mer sets are identical to packing each <=fragsize
    piece separately: whole-record k-mers crossing a fragment boundary
    are dropped, and minus-strand positions are remapped into each
    fragment's own reverse-complement coordinates.
    """
    k = index.k
    length = rec_codes.size
    n_frags = -(-length // fragsize) if length else 0
    if n_frags == 0:
        return {}, {}
    edges = np.minimum(
        np.arange(n_frags + 1, dtype=np.int64) * fragsize, length
    )

    def join_group(values, within, frag_id) -> dict[int, np.ndarray]:
        """One hash join (native when available) -> per-fragment diags.

        The native merge join buckets hits by fragment and sorts each
        fragment's diagonals in C++ -- hit counts reach tens of millions
        for Mb-scale pairs and this join (plus its numpy temporaries)
        dominated the old per-pair profile.
        """
        if values.size == 0:
            return {}
        # merge join wants the query side sorted by value: the native
        # counting sort (11-mer values < 2^22) replaces the numpy
        # argsort + three gathers and runs with the GIL released. It
        # sorts IN PLACE; the inputs here are always fresh copies (the
        # callers build them with boolean indexing / arithmetic), so
        # ascontiguousarray aliasing them is ownership transfer, not a
        # caller-visible mutation.
        v64 = np.ascontiguousarray(values, dtype=np.int64)
        w64 = np.ascontiguousarray(within, dtype=np.int64)
        f64 = np.ascontiguousarray(frag_id, dtype=np.int64)
        if not native.seed_sort_rows_native(v64, w64, f64):  # pragma: no cover
            order = np.argsort(values, kind="stable")
            v64, w64, f64 = values[order], within[order], frag_id[order]
        joined = native.seed_join_diags_native(
            index.values,
            index.positions,
            v64,
            w64,
            f64,
            n_frags,
        )
        if joined is None:  # pragma: no cover - no compiler
            qp_idx = np.arange(values.size)
            qp, sp = index.hits_packed(values, qp_idx)
            if qp.size == 0:
                return {}
            keys = (frag_id[qp] << np.int64(34)) + (
                sp - within[qp] + np.int64(fragsize)
            )
            keys.sort(kind="stable")
            fg = keys >> np.int64(34)
            dg = (keys & np.int64((1 << 34) - 1)) - fragsize
            starts = np.flatnonzero(
                np.concatenate(([True], fg[1:] != fg[:-1]))
            )
            bounds = np.concatenate((starts, [fg.size]))
            return {
                int(fg[s]): dg[s : bounds[i + 1]]
                for i, s in enumerate(starts)
            }
        diags, counts = joined
        offsets = np.concatenate(([0], np.cumsum(counts)))
        return {
            f: diags[offsets[f] : offsets[f + 1]]
            for f in np.flatnonzero(counts)
        }

    # Plus strand: fragment = pos // fragsize; a k-mer belongs to its
    # fragment iff it ends inside it (boundary-crossers are k-mers of
    # neither piece; the record tail's end is the record end, which
    # pack_kmers already respects).
    values, pos = pack_kmers(rec_codes, k)
    frag_id = pos // fragsize
    keep = pos + k <= edges[frag_id + 1]
    plus = join_group(
        values[keep], (pos % fragsize)[keep], frag_id[keep]
    )

    # Minus strand: one reverse complement of the whole record; fragment
    # f's rc piece occupies [length - edges[f+1], length - edges[f]).
    rc = complement_codes(rec_codes)[::-1].copy()
    values, pos = pack_kmers(rc, k)
    if values.size:
        rc_starts = length - edges[::-1]  # ascending interval starts
        seg = np.searchsorted(rc_starts, pos, side="right") - 1
        frag_id = n_frags - 1 - seg
        within = pos - rc_starts[seg]
        keep = pos + k <= rc_starts[seg + 1]
        minus = join_group(values[keep], within[keep], frag_id[keep])
    else:
        minus = {}
    return plus, minus


def column_fragment_candidates(
    query: Genome,
    subject_records: list[np.ndarray],
    seed_indexes: list[SeedIndex],
    fragsize: int,
) -> list[list[tuple[np.ndarray, np.ndarray, int]]]:
    """Candidates for EVERY fragment of ``query`` in one batched sweep.

    Produces exactly :func:`fragment_candidates`'s candidates in exactly
    its order (subject record -> strand -> band by count desc -> N-run
    splits) for each fragment, but with one hash join per (query record,
    subject record, strand) instead of one per fragment -- the per-call
    searchsorted/pack overhead dominated the old per-pair profile.
    """
    frag_meta: list[tuple[int, int, int]] = []  # (rec_idx, ordinal, size)
    frag_arrays: list[np.ndarray] = []
    for r_idx, rec in enumerate(query.records):
        n_frags = -(-len(rec.codes) // fragsize) if len(rec.codes) else 0
        for f in range(n_frags):
            piece = rec.codes[f * fragsize : (f + 1) * fragsize]
            frag_meta.append((r_idx, f, piece.size))
            frag_arrays.append(piece)

    # diags[(r_idx, s_idx, strand)][ordinal] -> sorted diag array
    diags: dict[tuple[int, int, int], dict[int, np.ndarray]] = {}
    for r_idx, rec in enumerate(query.records):
        for s_idx, index in enumerate(seed_indexes):
            plus, minus = _record_strand_diags(rec.codes, index, fragsize)
            diags[(r_idx, s_idx, 0)] = plus
            diags[(r_idx, s_idx, 1)] = minus

    results: list[list[tuple[np.ndarray, np.ndarray, int]]] = []
    for frag, (r_idx, ordinal, _size) in zip(frag_arrays, frag_meta):
        candidates: list[tuple[np.ndarray, np.ndarray, int]] = []
        frag_rc = None
        for s_idx, codes in enumerate(subject_records):
            for strand in (0, 1):
                d = diags[(r_idx, s_idx, strand)].get(ordinal)
                if d is None:
                    continue
                if strand == 0:
                    strand_frag = frag
                else:
                    if frag_rc is None:
                        frag_rc = complement_codes(frag)[::-1].copy()
                    strand_frag = frag_rc
                for diag_lo, diag_hi, _count in bands_from_sorted_diags(d):
                    w_lo = max(0, diag_lo - WINDOW_MARGIN)
                    w_hi = min(
                        codes.size, diag_hi + strand_frag.size + WINDOW_MARGIN
                    )
                    for _f_off, f_piece in split_at_n_runs(strand_frag):
                        for w_off, w_piece in split_at_n_runs(codes[w_lo:w_hi]):
                            candidates.append((f_piece, w_piece, w_lo + w_off))
        results.append(candidates)
    return results


def _score_host(pairs: list[tuple[np.ndarray, np.ndarray]]) -> list[int]:
    """Score-only pass per candidate via the native rolling-row DP.

    The native kernel releases the GIL inside ctypes, so large candidate
    sets run thread-parallel across host cores.
    """
    def one(pair: tuple[np.ndarray, np.ndarray]) -> int:
        strand_frag, window = pair
        score = native.local_align_score_native(
            strand_frag, window, REWARD, PENALTY, GAP_OPEN, GAP_EXTEND
        )
        if score is None:  # pragma: no cover - no compiler
            stats = local_align_stats(strand_frag, window)
            score = 0 if stats is None else stats.score
        return int(score)

    workers = intra_pair_workers()
    if workers > 1 and len(pairs) > 32:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(one, pairs, chunksize=16))
    return [one(p) for p in pairs]


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
    With a pair-grid mesh (``parallel/tiles.default_pair_mesh``: several
    cards in this process) the batch is split over its devices, one
    slice, copy, launch and event a device. On the CPU the plain version
    scores them here.
    """
    from pyani_plus_tpu_torch.parallel import tiles

    mesh = tiles.default_pair_mesh()
    devices = [backend.kernel_device()] if mesh is None else list(mesh.devices.flat)
    t_submit = devmeter.now()
    return batch_sw_best_submit(pairs, devices), t_submit


def _score_device_collect(state) -> tuple[list[int], list[tuple[int, int]]]:
    """Wait for a submitted batch: (scores, trims) per pair, where
    ``trims[i]`` is the winning (best_i, best_j) cell."""
    parts, t_submit = state
    out = batch_sw_best_collect(parts)
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


def _best_stats(
    candidates: list[tuple[np.ndarray, np.ndarray, int]],
    scores: list[int] | None,
    trims: list[tuple[int, int] | None] | None = None,
    min_score: float | None = None,
) -> AlignmentStats | None:
    """Exact stats DP on the winning candidate (first max on ties).

    When the winner's score is already known and fails the E-value gate
    the stats DP is skipped outright (the caller would discard the
    fragment either way -- device and stats scores are bit-equal, so
    the outcome is identical). A known winning cell trims the DP to the
    prefix rectangle query[:best_i] x window[:best_j]: DP values there
    are independent of the removed rows/columns and the argmax rule is
    inherited, so the traceback is unchanged (fuzz-locked).
    """
    if not candidates:
        return None
    if scores is not None and len(candidates) > 1:
        best_idx = max(range(len(candidates)), key=lambda i: scores[i])
    else:
        best_idx = 0
    if (
        scores is not None
        and min_score is not None
        and scores[best_idx] < min_score
    ):
        return None  # fragment fails the E-value score gate
    strand_frag, window, w_lo = candidates[best_idx]
    trim = trims[best_idx] if trims is not None else None
    if trim is not None and trim[0] > 0:
        strand_frag = strand_frag[: trim[0]]
        window = window[: trim[1]]
    stats = local_align_stats(strand_frag, window)
    if stats is None:
        return None
    return AlignmentStats(
        score=stats.score,
        length=stats.length,
        matches=stats.matches,
        mismatches=stats.mismatches,
        gaps=stats.gaps,
        gap_opens=stats.gap_opens,
        query_start=stats.query_start,
        query_end=stats.query_end,
        subject_start=w_lo + stats.subject_start,
        subject_end=w_lo + stats.subject_end,
    )


def best_fragment_alignment(
    frag: np.ndarray,
    subject_records: list[np.ndarray],
    seed_indexes: list[SeedIndex],
) -> AlignmentStats | None:
    """Best local alignment of one fragment over all subject sequences/strands."""
    candidates = fragment_candidates(frag, subject_records, seed_indexes)
    scores = None
    if len(candidates) > 1:
        scores = _score_host([(f, w) for f, w, _lo in candidates])
    return _best_stats(candidates, scores)


def _pair_tasks(
    query: Genome,
    subject: Genome,
    seed_indexes: list[SeedIndex],
    fragsize: int,
    *,
    include_singles: bool | None = None,
):
    """Candidate enumeration stage: (frags, per_frag, flat, spans).

    ``flat`` is the (strand_frag, window) score-task list; ``spans``
    maps each fragment to its (start, count) slice of ``flat`` (None
    when the fragment needs no score pass). With a device backend,
    single-candidate fragments are ALSO scored (include_singles): their
    winner is known without a score, but the device argmax supplies the
    stats-DP trim and the E-value pre-gate, which are worth far more
    than the amortised extra lane. On the host path scoring a single
    candidate is pure waste, so they are skipped there.
    """
    if include_singles is None:
        include_singles = use_device()
    subject_records = [rec.codes for rec in subject.records]
    frags = fragment_genome(query, fragsize)
    per_frag = column_fragment_candidates(
        query, subject_records, seed_indexes, fragsize
    )
    flat: list[tuple[np.ndarray, np.ndarray]] = []
    spans = []  # (start, count) into flat per fragment, or None
    min_cands = 1 if include_singles else 2
    for cands in per_frag:
        if len(cands) >= min_cands:
            spans.append((len(flat), len(cands)))
            flat.extend((f, w) for f, w, _lo in cands)
        else:
            spans.append(None)
    return frags, per_frag, flat, spans


def _pair_finalize(  # noqa: PLR0913
    query: Genome,
    subject: Genome,
    frags: list[np.ndarray],
    per_frag: list[list[tuple[np.ndarray, np.ndarray, int]]],
    spans: list[tuple[int, int] | None],
    flat_scores: list[int],
    flat_trims: list[tuple[int, int] | None] | None = None,
) -> tuple[float | None, int | None, int | None]:
    """Winner stats + accept/accumulate stage of one directed pair."""
    # Winning-candidate exact stats DPs are independent per fragment;
    # the native kernel releases the GIL, so run them in a thread pool.
    per_frag_scores: list[list[int] | None] = []
    per_frag_trims: list[list[tuple[int, int] | None] | None] = []
    for cands, span in zip(per_frag, spans):
        if span is not None:
            start, count = span
            per_frag_scores.append(flat_scores[start : start + count])
            per_frag_trims.append(
                flat_trims[start : start + count]
                if flat_trims is not None
                else None
            )
        else:
            per_frag_scores.append(None)
            per_frag_trims.append(None)
    # E-value gate thresholds, known before any stats DP runs: a winner
    # whose (device==stats) score fails the gate skips its DP entirely.
    thresholds = [_min_score(frag.size, subject.length) for frag in frags]
    workers = intra_pair_workers()
    if workers > 1 and len(frags) > 8:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            all_stats = list(
                pool.map(
                    _best_stats,
                    per_frag,
                    per_frag_scores,
                    per_frag_trims,
                    thresholds,
                    chunksize=8,
                )
            )
    else:
        all_stats = [
            _best_stats(c, s, t, ms)
            for c, s, t, ms in zip(
                per_frag, per_frag_scores, per_frag_trims, thresholds
            )
        ]

    total_pid_100 = 0.0
    total_count = 0
    total_aln_length = 0
    total_sim_errors = 0
    for frag, stats in zip(frags, all_stats):
        if stats is None:
            continue
        if stats.score < _min_score(frag.size, subject.length):
            continue
        ani_alnlen = stats.length - stats.gaps
        ani_query_coverage = ani_alnlen / frag.size
        ani_pid = (ani_alnlen - stats.mismatches) / frag.size
        if ani_query_coverage > MIN_COVERAGE and ani_pid > MIN_IDENTITY:
            total_aln_length += ani_alnlen
            total_sim_errors += stats.mismatches + stats.gaps
            # blastn prints pident with 3 decimals; parse re-reads it
            total_pid_100 += float(f"{stats.pident:.3f}")
            total_count += 1
    if not total_count:
        return None, None, None
    return (
        total_pid_100 / (total_count * 100),
        total_aln_length,
        total_sim_errors,
    )


def compute(ctx: ComputeContext) -> list[dict]:
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
