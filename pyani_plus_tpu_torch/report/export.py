"""Export a run: long-form comparison TSV plus the six matrices.

Format parity with the reference ``export-run`` (public_cli.py:974-1090):
``{method}_run_{run_id}.tsv`` long form with header
``#Query Subject Identity Query-Cov Subject-Cov Hadamard tANI Align-Len
Sim-Errors`` (NA for nulls), plus ``{method}_{identity,aln_lengths,
sim_errors,query_cov,hadamard,tANI}.tsv`` relabelled matrices.
"""

from __future__ import annotations

import logging
from math import log as math_log
from pathlib import Path

from pyani_plus_tpu_torch.db import Database
from pyani_plus_tpu_torch.utils import filename_stem


def _float_or_na(value: float | None) -> str:
    return "NA" if value is None else str(value)


def export_run_tables(
    logger: logging.Logger,
    db: Database,
    outdir: Path,
    run_id: int | None = None,
    label: str = "stem",
) -> None:
    """Write the long-form TSV and all six matrices for a run."""
    from pyani_plus_tpu_torch import log_sys_exit

    try:
        run = db.load_run(run_id, check_empty=True)
    except ValueError as err:
        log_sys_exit(logger, str(err))
    if run_id is None:
        logger.info("Exporting run-id %d", run.run_id)
    method = run.configuration.method

    if label == "md5":
        mapping = lambda x: x  # noqa: E731
    elif label == "filename":
        mapping = run.hash_to_filename.get
    else:
        mapping = {
            h: filename_stem(f) for h, f in run.hash_to_filename.items()
        }.get

    long_filename = f"{method}_run_{run.run_id}.tsv"
    with (outdir / long_filename).open("w") as handle:
        handle.write(
            "#Query\tSubject\tIdentity\tQuery-Cov\tSubject-Cov\tHadamard\ttANI"
            "\tAlign-Len\tSim-Errors\n"
        )
        for comp in run.comparisons():
            identity = comp["identity"]
            cov_query = comp["cov_query"]
            hadamard = (
                None if identity is None or cov_query is None else identity * cov_query
            )
            tani = None if not hadamard else -math_log(hadamard)
            handle.write(
                f"{mapping(comp['query_hash'])}\t{mapping(comp['subject_hash'])}"
                f"\t{_float_or_na(identity)}"
                f"\t{_float_or_na(cov_query)}"
                f"\t{_float_or_na(comp['cov_subject'])}"
                f"\t{_float_or_na(hadamard)}"
                f"\t{_float_or_na(tani)}"
                f"\t{_float_or_na(comp['aln_length'])}"
                f"\t{_float_or_na(comp['sim_errors'])}\n"
            )
    logger.info("Wrote long-form to %s/%s", outdir, long_filename)

    run = db.load_run(run.run_id, check_complete=True)
    for matrix, filename in (
        (run.identities, f"{method}_identity.tsv"),
        (run.aln_length, f"{method}_aln_lengths.tsv"),
        (run.sim_errors, f"{method}_sim_errors.tsv"),
        (run.cov_query, f"{method}_query_cov.tsv"),
        (run.hadamard, f"{method}_hadamard.tsv"),
        (run.tani, f"{method}_tANI.tsv"),
    ):
        matrix = run.relabelled_matrix(matrix, label)  # noqa: PLW2901
        matrix.to_csv(outdir / filename, sep="\t")
    logger.info("Wrote matrices to %s/%s_*.tsv", outdir, method)
