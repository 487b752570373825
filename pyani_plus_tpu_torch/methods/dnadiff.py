"""dnadiff: MUMmer dnadiff-equivalent AlignedBases/AvgIdentity ANI.

Port of ``pyani_plus_tpu/methods/dnadiff.py``: replaces ``nucmer
--maxmatch`` + ``delta-filter -m`` + ``show-coords -rclTH`` +
``show-diff -qH`` using the port's ANIm machinery (whose extensions run
on the CUDA kernel) with maxmatch seeding and the -m (union) chain
filter.

Scoring, per the reference methods/dnadiff.py:110-158 and
private_cli.py:1738-1756:

- identity = sum(pct/100 * (ref_len + qry_len)) / sum(ref_len + qry_len)
  where pct is the per-alignment %identity *as show-coords prints it*
  (2 decimal places) -- identity per alignment = (columns - errors) /
  columns over alignment columns including gaps;
- aligned_bases_with_gaps = sum of the full length of every query
  sequence that has at least one alignment (dnadiff.py:130-136);
- gaps = sum of positive query-gap lengths from the show-diff walk
  (BRK/GAP/JMP/INV features; DUP rows excluded -- dnadiff.py:140-158);
- aln_length = aligned_with_gaps - gaps;
  sim_errors = round(aln_length * (1 - identity));
  cov_query = aln_length / query_length; cov_subject = None.
"""

from __future__ import annotations

from pyani_plus_tpu_torch import __version__
from pyani_plus_tpu_torch.genomes import Genome
from pyani_plus_tpu_torch.methods import ComputeContext, run_pairwise
from pyani_plus_tpu_torch.methods.anim import align_sequences
from pyani_plus_tpu_torch.ops.chaining import Alignment, many_to_many

__all__ = ["NAME", "PROGRAM", "compute", "compute_pair", "configuration"]

NAME = "dnadiff"
PROGRAM = "pyani-plus-tpu-dnadiff"


def configuration() -> dict:
    return {
        "method": NAME,
        "program": PROGRAM,
        "version": __version__,
    }


def qdiff_features(
    alignments: list[Alignment], qry_len: int
) -> list[tuple[str, int]]:
    """show-diff -q features for one query sequence: (type, qry_gap_len).

    Walk the alignments sorted by query position: BRK for unaligned ends,
    GAP between consecutive alignments (negative for overlaps), DUP when
    the reference walks backwards over already-aligned territory while
    the query advances (the duplication case parse_qdiff excludes).
    """
    if not alignments:
        return []
    blocks = sorted(alignments, key=lambda a: (a.qry_start, a.qry_end))
    features: list[tuple[str, int]] = []
    first = blocks[0]
    if first.qry_start > 0:
        features.append(("BRK", first.qry_start))
    for prev, nxt in zip(blocks, blocks[1:]):
        gap_q = nxt.qry_start - prev.qry_end
        gap_r = nxt.ref_start - prev.ref_end
        if prev.reverse != nxt.reverse:
            features.append(("INV", gap_q))
        elif gap_r < 0 and gap_q >= 0:
            features.append(("DUP", gap_q))
        else:
            features.append(("GAP", gap_q))
    last = blocks[-1]
    if last.qry_end < qry_len:
        features.append(("BRK", qry_len - last.qry_end))
    return features


def compute_pair(query: Genome, subject: Genome) -> dict:
    """One directed dnadiff comparison (subject = nucmer reference)."""
    sum_identity = 0.0
    sum_lengths = 0
    aligned_with_gaps = 0
    gaps = 0
    # delta-filter -m runs per-sequence-per-axis chains over the WHOLE
    # delta (each ref contig's chain sees its alignments to every query
    # contig and vice versa), so filter once with grouping keys and only
    # then split the survivors per query sequence for the qdiff walk.
    all_blocks: list[Alignment] = []
    all_keys: list[tuple[int, int]] = []
    # Subject-outer so each subject record's suffix-automaton index is
    # reused across every query record before moving on -- query-outer
    # order evicts multi-contig subjects from the SAM cache between
    # uses (the filter below is order-insensitive, it groups by key).
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
    for q_idx, q_rec in enumerate(query.records):  # noqa: B007
        q_blocks = per_query.get(q_idx, [])
        if not q_blocks:
            continue
        aligned_with_gaps += len(q_rec)
        for a in q_blocks:
            columns = a.columns
            # show-coords %idy counts character non-identities: N-vs-N
            # is the same character (not an error) even though it scores
            # negatively -- that is why the reference's 28-N self pair is
            # dnadiff == 1.0 but ANIm == 0.9963 (test_self_vs_self.py:83-86).
            pct = (
                100.0 * (columns - a.char_errors) / columns if columns else 0.0
            )
            pct = float(f"{pct:.2f}")  # show-coords prints 2 decimals
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
    return run_pairwise(
        ctx, lambda q, s: compute_pair(ctx.genomes[q], ctx.genomes[s])
    )
