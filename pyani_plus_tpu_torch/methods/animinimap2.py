"""ANIminimap2: minimizer-chain alignment ANI (minimap2-equivalent).

Replaces ``minimap2 --secondary=no -x asm5|asm10|asm20`` (reference
invocation private_cli.py:1499-1549). The reference runs minimap2
WITHOUT -c, so the PAF nmatch/block-length columns are the chain's
anchor accounting (mlen/blen), not a base-level alignment -- the whole
method reduces to reproducing minimap2's sketch + chain exactly, which
ops/mm2.py + native/mm2.cpp do (all nine viral fixture PAFs match on
every parsed field: coordinates, strand, nmatch, block length, and the
mapq zero/nonzero gate).

Scoring per parse_minimap2_paf_file (reference animinimap2.py:65-139):
skip mapq==0 rows; identity = 2*sum(nmatch) / sum((tend-tstart+1) +
(qend-qstart+1)); aligned bases per genome via the inclusive interval
union of the raw PAF coordinates (anim.py:53-69); aln_length = query
aligned bases; cov = aligned bases / genome length; sim_errors = None
(private_cli.py:1556-1567).
"""

from __future__ import annotations

import numpy as np

from pyani_plus_tpu_torch import __version__
from pyani_plus_tpu_torch.genomes import Genome
from pyani_plus_tpu_torch.methods import ComputeContext
from pyani_plus_tpu_torch.ops.mm2 import PRESET_PARAMS, map_query_multi, sketch

NAME = "ANIminimap2"
PROGRAM = "pyani-plus-tpu-minimap2"

DEFAULT_PRESET = "asm20"  # ref animinimap2.py:49
SKETCH_CACHE_CAP = 64  # query-record sketches kept across subject columns


def configuration(*, mode: str = DEFAULT_PRESET) -> dict:
    return {
        "method": NAME,
        "program": PROGRAM,
        "version": __version__,
        "mode": mode,
    }


def _interval_union_inclusive(intervals: list[tuple[int, int]]) -> int:
    """Union size with the reference's +1-per-merged-interval accounting
    (PAF half-open ends fed to an inclusive counter, animinimap2.py:136)."""
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


def compute_pair(
    query: Genome,
    subject: Genome,
    preset: str,
    subject_index: tuple | None = None,
    sketch_cache: dict | None = None,
) -> dict:
    """One directed comparison; ``subject_index`` (from
    :func:`build_subject_index`) reuses the subject's sketches/index
    across queries, as the reference reuses one .mmi per subject, and
    ``sketch_cache`` memoises query sketches across subject columns."""
    k, w = PRESET_PARAMS.get(preset, PRESET_PARAMS[DEFAULT_PRESET])
    if subject_index is None:
        subject_index = build_subject_index(subject, preset)
    ref_records, ref_sketches, ref_index, mid_occ = subject_index
    aligned = 0
    identical = 0
    qry_regions: dict[int, list] = {}
    ref_regions: dict[int, list] = {}
    for qi, q_rec in enumerate(query.records):
        q_sk = None
        if sketch_cache is not None:
            key = (query.md5, qi, k, w)
            q_sk = sketch_cache.get(key)
            if q_sk is None:
                q_sk = sketch_cache[key] = sketch(q_rec.codes, k, w)
                # Bound the cache (~10 MB per bacterial record): small
                # runs keep every query sketch across subject columns,
                # huge runs degrade to per-column sketching, which the
                # chaining cost dominates anyway.
                while len(sketch_cache) > SKETCH_CACHE_CAP:
                    sketch_cache.pop(next(iter(sketch_cache)))
        for rec in map_query_multi(
            ref_records, q_rec.codes, k, w, ref_sketches, ref_index, mid_occ,
            qry_sketch=q_sk,
        ):
            if rec.mapq == 0:
                continue  # ref parser skips failed alignments (:99-101)
            aligned += (rec.tend - rec.tstart + 1) + (rec.qend - rec.qstart + 1)
            identical += rec.mlen
            ref_regions.setdefault(rec.tseq_id, []).append(
                (rec.tstart, rec.tend)
            )
            qry_regions.setdefault(qi, []).append((rec.qstart, rec.qend))
    if not aligned:
        return {
            "identity": None,
            "aln_length": None,
            "sim_errors": None,
            "cov_query": None,
            "cov_subject": None,
        }
    identity = 2.0 * identical / aligned
    qry_aligned = sum(_interval_union_inclusive(v) for v in qry_regions.values())
    ref_aligned = sum(_interval_union_inclusive(v) for v in ref_regions.values())
    # Reference worker derivations (private_cli.py:1556-1567):
    # aln_length = query aligned bases, sim_errors stays None
    return {
        "identity": identity,
        "aln_length": qry_aligned,
        "sim_errors": None,
        "cov_query": qry_aligned / query.length,
        "cov_subject": ref_aligned / subject.length,
    }


def build_subject_index(subject: Genome, preset: str) -> tuple:
    """(records, sketches, hash-sorted index, mid_occ) for one subject."""
    from pyani_plus_tpu_torch.ops.mm2 import build_index, mid_occ_threshold

    k, w = PRESET_PARAMS.get(preset, PRESET_PARAMS[DEFAULT_PRESET])
    ref_records = [rec.codes for rec in subject.records]
    ref_sketches = [sketch(rec, k, w) for rec in ref_records]
    ref_index = build_index(ref_sketches)
    return ref_records, ref_sketches, ref_index, mid_occ_threshold(ref_index[0])


def compute(ctx: ComputeContext) -> list[dict]:
    """All pending pairs, subject-major: one index build per subject."""
    preset = ctx.config.get("mode") or DEFAULT_PRESET
    rows: list[dict] = []
    sketch_cache: dict = {}
    try:
        for subject_hash in sorted({s for _q, s in ctx.pending}):
            subject_index = build_subject_index(
                ctx.genomes[subject_hash], preset
            )
            for query_hash in sorted(
                q for q, s in ctx.pending if s == subject_hash
            ):
                result = compute_pair(
                    ctx.genomes[query_hash],
                    ctx.genomes[subject_hash],
                    preset,
                    subject_index,
                    sketch_cache,
                )
                rows.append(
                    {
                        "query_hash": query_hash,
                        "subject_hash": subject_hash,
                        **result,
                    }
                )
                ctx.tick()
                ctx.maybe_flush(rows)
    except KeyboardInterrupt:
        ctx.interrupted = True
        ctx.logger.error(
            "Interrupted with %d completed comparisons", len(rows)
        )
    return rows
