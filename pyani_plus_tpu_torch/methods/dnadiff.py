"""dnadiff: MUMmer dnadiff-equivalent ANI over the port's ANIm alignment.

Port of ``pyani_plus_tpu/methods/dnadiff.py``: the same --maxmatch
alignment, -m (union) chain filter, show-diff walk and scoring, with the
alignment blocks coming from the port's ``align_sequences`` (whose
extensions run on the CUDA kernel). ``qdiff_features``,
``many_to_many`` and ``configuration`` are the JAX package's own.
"""

from __future__ import annotations

from pyani_plus_tpu.genomes import Genome
from pyani_plus_tpu.methods.dnadiff import (
    NAME,
    PROGRAM,
    configuration,
    qdiff_features,
)
from pyani_plus_tpu.ops.chaining import Alignment, many_to_many
from pyani_plus_tpu_torch.methods import ComputeContext, run_pairwise
from pyani_plus_tpu_torch.methods.anim import align_sequences, load_native_libraries

__all__ = ["NAME", "PROGRAM", "compute", "compute_pair", "configuration"]


def compute_pair(query: Genome, subject: Genome) -> dict:
    """One directed dnadiff comparison (subject = nucmer reference)."""
    sum_identity = 0.0
    sum_lengths = 0
    aligned_with_gaps = 0
    gaps = 0
    # delta-filter -m over the whole delta, grouped by (subject, query)
    # sequence; subject-outer keeps each subject's seed index warm.
    all_blocks: list[Alignment] = []
    all_keys: list[tuple[int, int]] = []
    for s_idx, s_rec in enumerate(subject.records):
        for q_idx, q_rec in enumerate(query.records):
            blocks = align_sequences(s_rec.codes, q_rec.codes, mode="maxmatch")
            all_blocks.extend(blocks)
            all_keys.extend([(s_idx, q_idx)] * len(blocks))
    kept = set(id(a) for a in many_to_many(all_blocks, all_keys))
    per_query: dict[int, list[Alignment]] = {}
    for key, block in zip(all_keys, all_blocks):
        if id(block) in kept:
            per_query.setdefault(key[1], []).append(block)
    for q_idx, q_rec in enumerate(query.records):
        q_blocks = per_query.get(q_idx, [])
        if not q_blocks:
            continue
        aligned_with_gaps += len(q_rec)
        for a in q_blocks:
            columns = a.columns
            # show-coords %idy counts character non-identities (N-vs-N is
            # the same character), printed to 2 decimals
            pct = (
                100.0 * (columns - a.char_errors) / columns if columns else 0.0
            )
            pct = float(f"{pct:.2f}")
            row_length = a.ref_len + a.qry_len
            sum_identity += pct * row_length / 100
            sum_lengths += row_length
        for kind, gap_q in qdiff_features(q_blocks, len(q_rec)):
            if kind != "DUP" and gap_q > 0:
                gaps += gap_q
    if not sum_lengths:
        return {
            "identity": None,
            "aln_length": None,
            "sim_errors": None,
            "cov_query": None,
            "cov_subject": None,
        }
    identity = sum_identity / sum_lengths
    aln_length = aligned_with_gaps - gaps
    sim_errors = round(aln_length * (1 - identity))
    return {
        "identity": identity,
        "aln_length": aln_length,
        "sim_errors": sim_errors,
        "cov_query": aln_length / query.length,
        "cov_subject": None,
    }


def compute(ctx: ComputeContext) -> list[dict]:
    load_native_libraries()
    return run_pairwise(
        ctx, lambda q, s: compute_pair(ctx.genomes[q], ctx.genomes[s])
    )
