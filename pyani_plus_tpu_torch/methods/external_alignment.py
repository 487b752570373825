"""external-alignment ANI: score a user-supplied whole-genome FASTA MSA.

Exact port of the reference's column math (methods/external_alignment.py:
33-157), vectorised over the whole matrix instead of per column:

- matches           = positions equal AND query non-gap
- non_gap_mismatches= unequal AND both non-gap
- either_gapped     = exactly one of the pair gapped
- aln_length        = matches + non_gap_mismatches + either_gapped
- sim_errors        = non_gap_mismatches + either_gapped
- identity          = matches / aln_length
- cov_query/subject = (matches + non_gap_mismatches) / ungapped length

This is the one *symmetric* method: only pairs with query_hash >=
subject_hash are computed, and both (q,s) and (s,q) rows are emitted
(ref external_alignment.py:88-91,148-157).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pyani_plus_tpu_torch import __version__, log_sys_exit
from pyani_plus_tpu_torch.methods import ComputeContext
from pyani_plus_tpu_torch.utils import fasta_bytes_iterator, file_md5sum, filename_stem

NAME = "external-alignment"
PROGRAM = "pyani-plus-tpu-msa"

ASCII_GAP = ord("-")


def configuration(*, alignment: Path, label: str = "stem") -> dict:
    checksum = file_md5sum(alignment)
    return {
        "method": NAME,
        "program": PROGRAM,
        "version": __version__,
        # Same packed-extra convention as the reference (public_cli.py:681)
        "extra": f"md5={checksum};label={label};alignment={alignment.name}",
    }


def _load_alignment(
    ctx: ComputeContext, label: str, alignment: Path
) -> dict[str, bytes]:
    """Map genome hash -> aligned sequence bytes via the chosen labelling."""
    if label == "md5":
        name_to_hash = {h: h for h in ctx.genomes}
    elif label == "filename":
        name_to_hash = {
            g.path.name: h for h, g in ctx.genomes.items()
        }
    else:  # stem
        name_to_hash = {
            filename_stem(g.path.name): h for h, g in ctx.genomes.items()
        }
    seqs: dict[str, bytes] = {}
    with alignment.open("rb") as handle:
        for title, seq in fasta_bytes_iterator(handle):
            name = title.decode().split(None, 1)[0]
            genome_hash = name_to_hash.get(name)
            if genome_hash is None:
                msg = f"Could not map {name} as {label}"
                log_sys_exit(ctx.logger, msg)
            seqs[genome_hash] = seq
    return seqs


def compute(ctx: ComputeContext) -> list[dict]:
    """Compute all pending pairs from the MSA (symmetric)."""
    extra = ctx.config.get("extra") or ""
    fields = dict(part.split("=", 1) for part in extra.split(";") if "=" in part)
    label = fields.get("label", "stem")

    alignment = ctx.extra_files.get("alignment")
    expected_md5 = fields.get("md5")
    if alignment is None:
        # Resume path: the configuration records the MSA's path, name
        # and content MD5. Try the recorded path, then the same name
        # beside the genomes; as a last resort accept ANY file in the
        # genome directories whose content MD5 matches the recorded one
        # (a moved-but-identical alignment must still resume).
        name = fields.get("alignment", "")
        genome_dirs = sorted({g.path.parent for g in ctx.genomes.values()})
        candidates = []
        if name:
            candidates.append(Path(name))
            candidates.extend(d / Path(name).name for d in genome_dirs)
        for c in candidates:
            if c.is_file() and (
                not expected_md5 or file_md5sum(c) == expected_md5
            ):
                alignment = c
                break
        if alignment is None and expected_md5:
            for d in genome_dirs:
                for c in sorted(p for p in d.iterdir() if p.is_file()):
                    if file_md5sum(c) == expected_md5:
                        alignment = c
                        break
                if alignment is not None:
                    break
        if alignment is None:
            msg = f"Cannot locate external alignment file {name!r}"
            log_sys_exit(ctx.logger, msg)

    if expected_md5 and file_md5sum(alignment) != expected_md5:
        msg = f"MD5 checksum of {alignment} does not match configuration"
        log_sys_exit(ctx.logger, msg)

    seqs = _load_alignment(ctx, label, alignment)
    missing = [h for h in ctx.genomes if h not in seqs]
    if missing:
        msg = f"Did not find {missing[0]} in {alignment.name}"
        log_sys_exit(ctx.logger, msg)

    arrays = {h: np.frombuffer(seq, dtype=np.uint8) for h, seq in seqs.items()}
    non_gaps = {h: a != ASCII_GAP for h, a in arrays.items()}
    ungapped = {h: int(m.sum()) for h, m in non_gaps.items()}

    rows: list[dict] = []

    def emit(q: str, s: str, vals: dict) -> None:
        if (q, s) in ctx.pending:
            rows.append({"query_hash": q, "subject_hash": s, **vals})
            ctx.tick()

    done_pairs: set[tuple[str, str]] = set()
    for q, s in sorted(ctx.pending):
        if (q, s) in done_pairs:
            continue
        if q == s:
            emit(
                q,
                s,
                {
                    "identity": 1.0,
                    "aln_length": ungapped[q],
                    "sim_errors": 0,
                    "cov_query": 1.0,
                    "cov_subject": 1.0,
                },
            )
            done_pairs.add((q, s))
            continue
        qa, sa = arrays[q], arrays[s]
        if qa.size != sa.size:
            msg = (
                f"Bad external-alignment, different lengths {qa.size} and {sa.size}"
                f" from {q} and {s}"
            )
            log_sys_exit(ctx.logger, msg)
        q_ng, s_ng = non_gaps[q], non_gaps[s]
        naive_matches = qa == sa
        matches = int((naive_matches & q_ng).sum())
        one_gapped = q_ng ^ s_ng
        non_gap_mismatches = int((~naive_matches & ~one_gapped).sum())
        either_gapped = int(one_gapped.sum())
        aln_length = matches + non_gap_mismatches + either_gapped
        sim_errors = non_gap_mismatches + either_gapped
        identity = matches / aln_length if aln_length else None
        cov_q = (matches + non_gap_mismatches) / ungapped[q] if ungapped[q] else None
        cov_s = (matches + non_gap_mismatches) / ungapped[s] if ungapped[s] else None
        emit(
            q,
            s,
            {
                "identity": identity,
                "aln_length": aln_length,
                "sim_errors": sim_errors,
                "cov_query": cov_q,
                "cov_subject": cov_s,
            },
        )
        emit(
            s,
            q,
            {
                "identity": identity,
                "aln_length": aln_length,
                "sim_errors": sim_errors,
                "cov_query": cov_s,
                "cov_subject": cov_q,
            },
        )
        done_pairs.add((q, s))
        done_pairs.add((s, q))
    return rows
