"""The ``pyani-plus-tpu-torch`` command line application.

The ported methods (``anim``, ``dnadiff``, ``anib``, ``sourmash``) and
``resume`` run through the port's runner; the report commands
(``list-runs``, ``delete-run``, ``export-run``, ``classify``,
``plot-run``, ``plot-run-comp``, ``export-comparisons``,
``import-comparisons``) read the port's own store and report modules.
Flags and output match ``pyani-plus-tpu``, so a run of either package
can be listed, exported, classified, plotted or resumed by the other.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

import click

from pyani_plus_tpu_torch import (
    GRAPHICS_FORMATS,
    __version__,
    log_sys_exit,
    setup_logger,
)
from pyani_plus_tpu_torch.db import Database
from pyani_plus_tpu_torch.parallel import resume_run, start_and_run_method
from pyani_plus_tpu_torch.utils import check_db


def _logger(log: Path | None, *, debug: bool) -> logging.Logger:
    return setup_logger(
        log if log and str(log) != "-" else None,
        terminal_level=logging.DEBUG if debug else logging.INFO,
    )


def _parse_formats(logger, formats: str) -> tuple[str, ...]:
    """Validated --formats tuple; clean exit on unsupported entries
    (GRAPHICS_FORMATS) instead of letting matplotlib raise a traceback."""
    parts = tuple(p.strip() for p in formats.split(",") if p.strip())
    bad = [p for p in parts if p not in GRAPHICS_FORMATS]
    if bad or not parts:
        log_sys_exit(
            logger,
            f"Unsupported plot format(s) {', '.join(bad) or '(none given)'}"
            f" -- supported: {', '.join(GRAPHICS_FORMATS)}",
        )
    return parts


def _load_run_checked(logger, db, run_id, **checks):
    """load_run with user-facing error reporting (CRITICAL + exit), so an
    unknown --run-id or incomplete run prints cleanly instead of a
    traceback (reference public_cli error style)."""
    try:
        return db.load_run(run_id, **checks)
    except ValueError as err:
        log_sys_exit(logger, str(err))


def _cmdline() -> str:
    return " ".join(sys.argv)


# Shared options (ref public_cli_args.py)
def common_run_options(f):
    f = click.option("--name", default=None, help="Run name for the database")(f)
    f = click.option(
        "--create-db", is_flag=True, default=False, help="Create database if needed"
    )(f)
    f = click.option(
        "-d",
        "--database",
        required=True,
        type=click.Path(path_type=Path, dir_okay=False),
        help="Path to pyANI-plus SQLite3 database",
    )(f)
    f = click.option(
        "--cache",
        default=Path(),
        type=click.Path(path_type=Path, file_okay=False),
        help="Cache directory (sketches etc); default is the current directory",
    )(f)
    f = click.option(
        "--log",
        default=None,
        type=click.Path(path_type=Path, dir_okay=False),
        help="Log file (use '-' for none)",
    )(f)
    f = click.option("--debug", is_flag=True, default=False, help="Debug logging")(f)
    f = click.argument("fasta", type=click.Path(path_type=Path, file_okay=False))(f)
    return f


@click.group()
@click.version_option(version=__version__)
def app() -> None:
    """pyANI-plus-TPU on PyTorch/CUDA: whole-genome ANI with H100 kernels."""


def _run_method(  # noqa: PLR0913
    method: str,
    fasta: Path,
    database: Path,
    *,
    name: str | None,
    create_db: bool,
    cache: Path | None,
    log: Path | None,
    debug: bool,
    **params,
) -> None:
    logger = _logger(log, debug=debug)
    check_db(logger, database, create_db)
    run_id = start_and_run_method(
        logger,
        database,
        fasta,
        method,
        name=name,
        cmdline=_cmdline(),
        create_db=create_db,
        cache=cache,
        **params,
    )
    click.echo(f"Run {run_id} complete")


@app.command(name="anim")
@common_run_options
@click.option(
    "--mode",
    type=click.Choice(["mum", "maxmatch"]),
    default="mum",
    show_default=True,
    help="Seed matching mode",
)
def anim_cmd(  # noqa: PLR0913
    fasta: Path,
    database: Path,
    name: str | None,
    create_db: bool,
    cache: Path | None,
    log: Path | None,
    debug: bool,
    mode: str,
) -> None:
    """Whole-genome alignment ANI (nucmer/ANIm-equivalent, CUDA extensions)."""
    _run_method(
        "ANIm",
        fasta,
        database,
        name=name,
        create_db=create_db,
        cache=cache,
        log=log,
        debug=debug,
        mode=mode,
    )


@app.command(name="dnadiff")
@common_run_options
def dnadiff_cmd(  # noqa: PLR0913
    fasta: Path,
    database: Path,
    name: str | None,
    create_db: bool,
    cache: Path | None,
    log: Path | None,
    debug: bool,
) -> None:
    """MUMmer dnadiff-equivalent ANI (CUDA extensions)."""
    _run_method(
        "dnadiff",
        fasta,
        database,
        name=name,
        create_db=create_db,
        cache=cache,
        log=log,
        debug=debug,
    )


@app.command(name="anib")
@common_run_options
@click.option("--fragsize", default=1020, show_default=True, help="Fragment length")
def anib_cmd(  # noqa: PLR0913
    fasta: Path,
    database: Path,
    name: str | None,
    create_db: bool,
    cache: Path | None,
    log: Path | None,
    debug: bool,
    fragsize: int,
) -> None:
    """Fragment-alignment ANI (BLAST/ANIb-equivalent, CUDA Smith-Waterman)."""
    _run_method(
        "ANIb",
        fasta,
        database,
        name=name,
        create_db=create_db,
        cache=cache,
        log=log,
        debug=debug,
        fragsize=fragsize,
    )


@app.command(name="sourmash")
@common_run_options
@click.option(
    "--scaled", default=1000, show_default=True, help="FracMinHash scaled parameter"
)
@click.option("-k", "--kmersize", default=31, show_default=True, help="k-mer size")
def sourmash_cmd(  # noqa: PLR0913
    fasta: Path,
    database: Path,
    name: str | None,
    create_db: bool,
    cache: Path | None,
    log: Path | None,
    debug: bool,
    scaled: int,
    kmersize: int,
) -> None:
    """FracMinHash containment ANI (sourmash-equivalent, Gram on the card)."""
    _run_method(
        "sourmash",
        fasta,
        database,
        name=name,
        create_db=create_db,
        cache=cache,
        log=log,
        debug=debug,
        kmersize=kmersize,
        scaled=scaled,
    )


@app.command(name="resume")
@click.option(
    "-d",
    "--database",
    required=True,
    type=click.Path(path_type=Path, dir_okay=False, exists=True),
)
@click.option("--run-id", default=None, type=int, help="Run to resume (default latest)")
@click.option(
    "--cache", default=Path(), type=click.Path(path_type=Path, file_okay=False)
)
@click.option("--log", default=None, type=click.Path(path_type=Path, dir_okay=False))
@click.option("--debug", is_flag=True, default=False)
def resume_cmd(
    database: Path,
    run_id: int | None,
    cache: Path | None,
    log: Path | None,
    debug: bool,
) -> None:
    """Resume a partial run of a ported method (missing comparisons only)."""
    logger = _logger(log, debug=debug)
    with Database(database, logger=logger) as db:
        run = _load_run_checked(logger, db, run_id)
        logger.info(
            "Resuming run %d (%s, status %r)",
            run.run_id,
            run.configuration.method,
            run.status,
        )
        missing = [
            f
            for f in (
                Path(run.fasta_directory) / name
                for name in run.hash_to_filename.values()
            )
            if not f.is_file()
        ]
        if missing:
            msg = f"Missing {len(missing)} FASTA files, e.g. {missing[0]}"
            log_sys_exit(logger, msg)
        run.set_status("Resuming")
        resume_run(logger, db, run, cache=cache)
    click.echo(f"Run {run.run_id} resumed")


@app.command(name="list-runs")
@click.option(
    "-d",
    "--database",
    required=True,
    type=click.Path(path_type=Path, dir_okay=False, exists=True),
)
@click.option("--log", default=None, type=click.Path(path_type=Path, dir_okay=False))
@click.option("--debug", is_flag=True, default=False)
def list_runs(database: Path, log: Path | None, debug: bool) -> None:
    """List all runs in the database with completion counts."""
    _logger(log, debug=debug)
    from rich.console import Console
    from rich.table import Table

    with Database(database) as db:
        table = Table(title=f"Runs in {database}")
        for col in (
            "ID",
            "Date",
            "Method",
            "Genomes",
            "Done",
            "Null",
            "Miss",
            "Total",
            "Status",
            "Name",
        ):
            table.add_column(col)
        for run in db.list_runs():
            n = len(run.genome_hashes)
            done, null = run.comparison_status_counts()
            miss = n * n - done - null
            table.add_row(
                str(run.run_id),
                run.date[:19],
                run.configuration.method,
                str(n),
                str(done),
                str(null),
                str(miss),
                str(n * n),
                run.status,
                run.name,
            )
        Console().print(table)


@app.command(name="delete-run")
@click.option(
    "-d",
    "--database",
    required=True,
    type=click.Path(path_type=Path, dir_okay=False, exists=True),
)
@click.option("--run-id", default=None, type=int, help="Run to delete (default latest)")
@click.option("--force", is_flag=True, default=False, help="Do not ask for confirmation")
@click.option("--log", default=None, type=click.Path(path_type=Path, dir_okay=False))
@click.option("--debug", is_flag=True, default=False)
def delete_run(
    database: Path, run_id: int | None, force: bool, log: Path | None, debug: bool
) -> None:
    """Delete a run (the underlying comparisons are kept for reuse)."""
    logger = _logger(log, debug=debug)
    with Database(database, logger=logger) as db:
        run = _load_run_checked(logger, db, run_id)
        if not force:
            click.confirm(
                f"Delete run {run.run_id} ({run.configuration.method},"
                f" {run.name!r})?",
                abort=True,
            )
        db.delete_run(run.run_id)
        click.echo(f"Deleted run {run.run_id}")


@app.command(name="export-run")
@click.option(
    "-d",
    "--database",
    required=True,
    type=click.Path(path_type=Path, dir_okay=False),
)
@click.option(
    "-o",
    "--outdir",
    required=True,
    type=click.Path(path_type=Path, file_okay=False),
)
@click.option("--run-id", default=None, type=int, help="Run to export (default latest)")
@click.option(
    "--label",
    type=click.Choice(["md5", "filename", "stem"]),
    default="stem",
    show_default=True,
)
@click.option("--log", default=None, type=click.Path(path_type=Path, dir_okay=False))
@click.option("--debug", is_flag=True, default=False)
def export_run(  # noqa: PLR0913
    database: Path,
    outdir: Path,
    run_id: int | None,
    label: str,
    log: Path | None,
    debug: bool,
) -> None:
    """Export a run: long-form TSV + six matrices (ref public_cli.py:974-1090)."""
    from pyani_plus_tpu_torch.report.export import export_run_tables

    logger = _logger(log, debug=debug)
    if str(database) == ":memory:" or not Path(database).is_file():
        msg = f"Database {database} does not exist"
        log_sys_exit(logger, msg)
    if not outdir.is_dir():
        logger.warning("Output directory %s does not exist, making it.", outdir)
        outdir.mkdir(parents=True)
    with Database(database, logger=logger) as db:
        export_run_tables(logger, db, outdir, run_id, label)
    click.echo(f"Wrote matrices to {outdir}")


@app.command(name="classify")
@click.option(
    "-d",
    "--database",
    required=True,
    type=click.Path(path_type=Path, dir_okay=False, exists=True),
)
@click.option(
    "-o",
    "--outdir",
    required=True,
    type=click.Path(path_type=Path, file_okay=False),
)
@click.option("--run-id", default=None, type=int)
@click.option(
    "--mode",
    type=click.Choice(["identity", "tANI"]),
    default="identity",
    show_default=True,
)
@click.option("--cov-min", default=0.5, show_default=True)
@click.option(
    "--label",
    type=click.Choice(["md5", "filename", "stem"]),
    default="stem",
    show_default=True,
)
@click.option(
    "--score-edges",
    type=click.Choice(["min", "mean", "max"]),
    default="mean",
    show_default=True,
    help="How to resolve asymmetrical identity/tANI for edges",
)
@click.option(
    "--coverage-edges",
    type=click.Choice(["min", "mean", "max"]),
    default="min",
    show_default=True,
    help="How to resolve asymmetrical coverage for edges",
)
@click.option(
    "--vertical-line",
    default=0.95,
    show_default=True,
    help="Threshold for red vertical line at identity/tANI",
)
@click.option("--no-plot", is_flag=True, default=False, help="Skip the summary plot")
@click.option(
    "--formats",
    default="tsv,png",
    show_default=True,
    help="Comma-separated plot output formats",
)
@click.option("--log", default=None, type=click.Path(path_type=Path, dir_okay=False))
@click.option("--debug", is_flag=True, default=False)
def classify_cmd(  # noqa: PLR0913
    database: Path,
    outdir: Path,
    run_id: int | None,
    mode: str,
    cov_min: float,
    label: str,
    score_edges: str,
    coverage_edges: str,
    vertical_line: float,
    no_plot: bool,
    formats: str,
    log: Path | None,
    debug: bool,
) -> None:
    """Classify genomes into cliques at decreasing identity thresholds."""
    from pyani_plus_tpu_torch.report.classify import classify_run

    logger = _logger(log, debug=debug)
    if not outdir.is_dir():
        outdir.mkdir(parents=True)
    with Database(database, logger=logger) as db:
        classify_run(
            logger,
            db,
            outdir,
            run_id=run_id,
            mode=mode,
            label=label,
            cov_min=cov_min,
            score_agg=score_edges,
            cov_agg=coverage_edges,
            vertical_line=vertical_line,
            plot=not no_plot,
            formats=_parse_formats(logger, formats),
        )
    click.echo(f"Wrote classify output to {outdir}")


@app.command(name="plot-run")
@click.option(
    "-d",
    "--database",
    required=True,
    type=click.Path(path_type=Path, dir_okay=False, exists=True),
)
@click.option(
    "-o",
    "--outdir",
    required=True,
    type=click.Path(path_type=Path, file_okay=False),
)
@click.option("--run-id", default=None, type=int)
@click.option(
    "--label",
    type=click.Choice(["md5", "filename", "stem"]),
    default="stem",
    show_default=True,
)
@click.option(
    "--formats",
    default="png,tsv",
    show_default=True,
    help="Comma-separated output formats (tsv,png,jpg,svgz,pdf)",
)
@click.option("--log", default=None, type=click.Path(path_type=Path, dir_okay=False))
@click.option("--debug", is_flag=True, default=False)
def plot_run_cmd(  # noqa: PLR0913
    database: Path,
    outdir: Path,
    run_id: int | None,
    label: str,
    formats: str,
    log: Path | None,
    debug: bool,
) -> None:
    """Plot heatmaps, distributions and scatter plots for a single run."""
    from pyani_plus_tpu_torch.report.plots import plot_single_run

    logger = _logger(log, debug=debug)
    if not outdir.is_dir():
        outdir.mkdir(parents=True)
    with Database(database, logger=logger) as db:
        run = _load_run_checked(
            logger, db, run_id, check_complete=True, check_empty=True
        )
        plot_single_run(
            logger, run, outdir, label=label, formats=_parse_formats(logger, formats)
        )
    click.echo(f"Wrote plots to {outdir}")


@app.command(name="plot-run-comp")
@click.option(
    "-d",
    "--database",
    required=True,
    type=click.Path(path_type=Path, dir_okay=False, exists=True),
)
@click.option(
    "-o",
    "--outdir",
    required=True,
    type=click.Path(path_type=Path, file_okay=False),
)
@click.option("--run-ids", required=True, help="Comma-separated run IDs: base,other[,..]")
@click.option(
    "--formats",
    default="png",
    show_default=True,
)
@click.option("--log", default=None, type=click.Path(path_type=Path, dir_okay=False))
@click.option("--debug", is_flag=True, default=False)
def plot_run_comp_cmd(  # noqa: PLR0913
    database: Path,
    outdir: Path,
    run_ids: str,
    formats: str,
    log: Path | None,
    debug: bool,
) -> None:
    """Compare runs: scatter/difference plots of identity between runs."""
    from pyani_plus_tpu_torch.report.plots import plot_run_comparison

    logger = _logger(log, debug=debug)
    if not outdir.is_dir():
        outdir.mkdir(parents=True)
    ids = [int(x) for x in run_ids.split(",")]
    with Database(database, logger=logger) as db:
        plot_run_comparison(
            logger, db, outdir, ids, formats=_parse_formats(logger, formats)
        )
    click.echo(f"Wrote comparison plots to {outdir}")


@app.command(name="export-comparisons")
@click.option(
    "-d",
    "--database",
    required=True,
    type=click.Path(path_type=Path, dir_okay=False, exists=True),
)
@click.option("--run-id", default=None, type=int, help="Run to export (default latest)")
@click.option(
    "-o",
    "--output",
    required=True,
    type=click.Path(path_type=Path, dir_okay=False),
    help="JSON file to write",
)
@click.option("--log", default=None, type=click.Path(path_type=Path, dir_okay=False))
@click.option("--debug", is_flag=True, default=False)
def export_comparisons_cmd(
    database: Path, run_id: int | None, output: Path, log: Path | None, debug: bool
) -> None:
    """Export a run's comparisons as a JSON batch (worker transport).

    Same structure as the reference's export_json_db_entries
    (private_cli.py:454-504): {"configuration": ..., "uname": ...,
    "comparisons": [...]}, so batches can be shipped between hosts
    without a shared filesystem and merged idempotently.
    """
    import json
    import platform

    logger = _logger(log, debug=debug)
    with Database(database, logger=logger) as db:
        run = _load_run_checked(logger, db, run_id)
        config = run.configuration
        comparisons = [
            {
                "query_hash": row["query_hash"],
                "subject_hash": row["subject_hash"],
                "identity": row["identity"],
                "aln_length": row["aln_length"],
                "sim_errors": row["sim_errors"],
                "cov_query": row["cov_query"],
                "cov_subject": row["cov_subject"],
            }
            for row in run.comparisons()
        ]
    uname = platform.uname()
    output.write_text(
        json.dumps(
            {
                "configuration": {
                    "method": config.method,
                    "program": config.program,
                    "version": config.version,
                    "fragsize": config.fragsize,
                    "mode": config.mode,
                    "kmersize": config.kmersize,
                    "minmatch": config.minmatch,
                    "extra": config.extra,
                },
                "uname": {
                    "system": uname.system,
                    "release": uname.release,
                    "machine": uname.machine,
                },
                "comparisons": comparisons,
            }
        )
    )
    click.echo(f"Exported {len(comparisons)} comparisons to {output}")


@app.command(name="import-comparisons")
@click.option(
    "-d",
    "--database",
    required=True,
    type=click.Path(path_type=Path, dir_okay=False, exists=True),
)
@click.argument(
    "json_files",
    nargs=-1,
    required=True,
    type=click.Path(path_type=Path, dir_okay=False, exists=True),
)
@click.option("--log", default=None, type=click.Path(path_type=Path, dir_okay=False))
@click.option("--debug", is_flag=True, default=False)
def import_comparisons_cmd(
    database: Path, json_files: tuple[Path, ...], log: Path | None, debug: bool
) -> None:
    """Import JSON comparison batches (reference import_json_comparisons).

    Validates the structure, maps the embedded configuration to a
    configuration row (created if needed), and bulk-inserts with
    INSERT OR IGNORE -- re-importing the same batch is a no-op
    (private_cli.py:507-614 semantics).
    """
    import json

    logger = _logger(log, debug=debug)
    total = 0
    with Database(database, logger=logger) as db:
        # Import is a merge into an EXISTING analysis: the reference
        # refuses databases with no configurations/genomes and JSON
        # whose configuration the database has never seen
        # (private_cli.py import_comparisons error contract).
        if not db.conn.execute("SELECT COUNT(*) FROM configurations").fetchone()[0]:
            log_sys_exit(
                logger, f"Database '{database}' does not contain any configurations"
            )
        if not db.conn.execute("SELECT COUNT(*) FROM genomes").fetchone()[0]:
            log_sys_exit(
                logger, f"Database '{database}' does not contain any genomes"
            )
        for json_file in json_files:
            raw = json_file.read_bytes()
            if not raw:
                logger.warning("JSON file '%s' is empty", json_file)
                logger.info("Imported 0 from '%s'", json_file)
                continue
            try:
                payload = json.loads(raw)
            except json.JSONDecodeError:
                log_sys_exit(logger, f"JSON file '{json_file}' invalid")
            if not isinstance(payload, dict) or any(
                key not in payload
                for key in ("configuration", "uname", "comparisons")
            ):
                log_sys_exit(
                    logger,
                    f"JSON file '{json_file}' does not use the expected structure",
                )
            config = payload["configuration"]
            uname = payload["uname"]
            if any(key not in config for key in ("method", "program", "version")):
                log_sys_exit(
                    logger, f"JSON file '{json_file}' configuration incomplete"
                )
            if any(key not in uname for key in ("system", "release", "machine")):
                log_sys_exit(logger, f"JSON file '{json_file}' uname incomplete")
            try:
                config_id = db.get_or_create_configuration(
                    method=config["method"],
                    program=config["program"],
                    version=config["version"],
                    fragsize=config.get("fragsize"),
                    mode=config.get("mode"),
                    kmersize=config.get("kmersize"),
                    minmatch=config.get("minmatch"),
                    extra=config.get("extra"),
                    create=False,
                ).configuration_id
            except ValueError:
                log_sys_exit(
                    logger,
                    f"JSON file '{json_file}' configuration not in database",
                )
            if not payload["comparisons"]:
                logger.warning("JSON file '%s' has no comparisons", json_file)
                continue
            rows = []
            for entry in payload["comparisons"]:
                if any(
                    key not in entry
                    for key in ("query_hash", "subject_hash", "identity")
                ):
                    log_sys_exit(
                        logger,
                        f"JSON file '{json_file}' comparison(s) incomplete",
                    )
                rows.append(
                    {
                        **entry,
                        "uname_system": uname.get("system", ""),
                        "uname_release": uname.get("release", ""),
                        "uname_machine": uname.get("machine", ""),
                    }
                )
            db.insert_comparisons(rows, configuration_id=config_id)
            total += len(rows)
            logger.info("Imported %d comparisons from %s", len(rows), json_file)
    click.echo(f"Imported {total} comparisons")


if __name__ == "__main__":
    app()
