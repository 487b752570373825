"""The ``pyani-plus-tpu-torch`` command line application.

The ported methods (``anim``, ``dnadiff``, ``anib``, ``sourmash``) and ``resume`` run through
the port's runner; the report commands carry no JAX and are the JAX
package's own, added to this group as they are. Flags and output match
``pyani-plus-tpu``, so a run of either package can be listed, exported,
classified, plotted or resumed by the other.
"""

from __future__ import annotations

from pathlib import Path

import click

from pyani_plus_tpu import __version__, log_sys_exit
from pyani_plus_tpu.cli.main import (
    _cmdline,
    _load_run_checked,
    _logger,
    classify_cmd,
    common_run_options,
    delete_run,
    export_comparisons_cmd,
    export_run,
    import_comparisons_cmd,
    list_runs,
    plot_run_cmd,
    plot_run_comp_cmd,
)
from pyani_plus_tpu.db import Database
from pyani_plus_tpu.utils import check_db
from pyani_plus_tpu_torch.parallel import resume_run, start_and_run_method


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


for _command in (
    list_runs,
    delete_run,
    export_run,
    classify_cmd,
    plot_run_cmd,
    plot_run_comp_cmd,
    export_comparisons_cmd,
    import_comparisons_cmd,
):
    app.add_command(_command)


if __name__ == "__main__":
    app()
