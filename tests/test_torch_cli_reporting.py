"""The port's reporting and maintenance CLI against the JAX package's.

The counterpart of ``tests/test_cli_reporting.py``, case for case:
export-run's label modes, list-runs' counts and status, delete-run's
confirmation, classify's gates and cliques, and the error branches of
resume, export-run, plot-run and classify. Each case gives each package
in turn the same store at the same path, made with that package's own
CLI, and runs that package's CLI on it. The two must agree on the exit
code, on the exception that ended the command, on the message text (log
time stamps, run dates, line breaks and the port's line naming its device
aside) and on every TSV written; the port must also meet the JAX test's
own assertions.

The JAX file reads the reference's viral genomes and ``bad_alignments``
pair. Here sourmash runs over three genomes made from a seed, two of them
close relatives and one far from both, and the NULL case runs ANIm over
two unrelated random genomes, whose cross comparisons are NULL (asserted).
"""

from __future__ import annotations

import re
import shutil
import sqlite3
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import pytest
from click.testing import CliRunner

from pyani_plus_tpu.cli.main import app as jax_app
from pyani_plus_tpu.db import Database as JaxDatabase
from pyani_plus_tpu_torch import __version__
from pyani_plus_tpu_torch.cli.main import app as torch_app
from pyani_plus_tpu_torch.db import Database as TorchDatabase
from pyani_plus_tpu_torch.synthetic import write_fasta, write_genome_dir
from pyani_plus_tpu_torch.utils import file_md5sum

PACKAGES = {"jax": (jax_app, JaxDatabase), "torch": (torch_app, TorchDatabase)}
WORK = "{work}"  # in an argument list: the case's working directory
DB = f"{WORK}/db.sqlite"  # the case's copy of the package's sourmash store
STEMS = {"genome_0", "genome_1", "genome_2"}


class Outcome(NamedTuple):
    exit_code: int
    exception: str | None  # the type of what ended the command, if not a clean exit
    text: str
    tsvs: dict[str, list[str]]  # name -> sorted lines of every TSV under the work directory


def _text(output: str) -> str:
    """The CLI's output without rich's time stamps, the runs' dates and
    line breaks, and without the one line the port adds: the device its
    method runs on (``parallel/runner.require_device``)."""
    output = re.sub(r"\[\d\d/\d\d/\d\d \d\d:\d\d:\d\d\]", " ", output)
    text = " ".join(re.sub(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d", "DATE", output).split())
    return re.sub(r"INFO \S+ runs on (cpu|cuda\S*)( |$)", "", text)


def _invoke(app, argv: list[str], work: Path, stdin: str | None) -> tuple:
    result = CliRunner().invoke(
        app, [arg.replace(WORK, str(work)) for arg in argv], input=stdin,
        env={"COLUMNS": "200"},
    )  # fmt: skip
    exception = result.exception
    kind = None if exception is None or isinstance(exception, SystemExit) else type(exception).__name__
    return result.exit_code, kind, _text(result.output)


def _tsvs(work: Path) -> dict[str, list[str]]:
    return {
        str(path.relative_to(work)): sorted(path.read_text().splitlines())
        for path in sorted(work.rglob("*.tsv"))
    }


def _both(
    tmp_path: Path,
    commands: list[list[str]],
    build: Callable[[Path, str], None] | None = None,
    stdin: str | None = None,
) -> list[Outcome]:
    """Give each package in turn a fresh working directory, ``build(work,
    tag)`` in it, then run ``commands`` through its CLI; assert both agree
    and return the port's outcomes (the TSVs as they stand after each)."""
    outcomes = {}
    work = tmp_path / "work"
    for tag, (app, _database) in PACKAGES.items():
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        if build is not None:
            build(work, tag)
        outcomes[tag] = [
            Outcome(*_invoke(app, argv, work, stdin), _tsvs(work)) for argv in commands
        ]
    assert outcomes["torch"] == outcomes["jax"]
    return outcomes["torch"]


@pytest.fixture(scope="module")
def genomes(tmp_path_factory) -> Path:
    """Three 200 kb genomes of one ancestor: genome_0 and genome_1 at
    0.2% and 0.4% substitutions, genome_2 at 30%."""
    directory = tmp_path_factory.mktemp("report_genomes")
    write_genome_dir(directory, 200_000, [0.002, 0.004, 0.3], seed=17)
    return directory


@pytest.fixture(scope="module")
def done_dbs(tmp_path_factory, genomes) -> dict[str, Path]:
    """One complete sourmash run, by each package's CLI."""
    tmp = tmp_path_factory.mktemp("report_cli")
    dbs = {}
    for tag, (app, _database) in PACKAGES.items():
        dbs[tag] = tmp / f"{tag}.sqlite"
        result = CliRunner().invoke(
            app,
            ["sourmash", str(genomes), "-d", str(dbs[tag]), "--create-db",
             "--name", "my synthetic run", "--cache", str(tmp)],  # fmt: skip
            catch_exceptions=False,
        )
        assert result.exit_code == 0, result.output
    return dbs


@pytest.fixture()
def done(done_dbs) -> Callable[[Path, str], None]:
    """``build`` for ``_both``: the package's sourmash store at ``DB``."""

    def build(work: Path, tag: str) -> None:
        shutil.copy(done_dbs[tag], work / "db.sqlite")

    return build


def _empty_db(work: Path, tag: str) -> None:
    PACKAGES[tag][1](work / "empty.sqlite", create=True).close()


def test_export_run_label_modes(tmp_path, genomes, done) -> None:
    """stem (default), filename and md5 labelling of exported matrices."""
    expected = {
        "stem": STEMS,
        "filename": {f"{stem}.fna" for stem in STEMS},
        "md5": {file_md5sum(genomes / f"{stem}.fna") for stem in STEMS},
    }
    commands = [["export-run", "-d", DB, "-o", f"{WORK}/{label}", "--label", label]
                for label in expected]  # fmt: skip
    outcomes = _both(tmp_path, commands, done)
    for outcome, (label, names) in zip(outcomes, expected.items()):
        assert outcome.exit_code == 0, outcome.text
        lines = outcome.tsvs[f"{label}/sourmash_identity.tsv"]
        assert {line.split("\t")[0] for line in lines} == {"", *names}, label


def test_export_run_unknown_run_id_errors(tmp_path, done) -> None:
    [outcome] = _both(tmp_path, [["export-run", "-d", DB, "-o", f"{WORK}/x", "--run-id", "99"]],
                      done)  # fmt: skip
    assert outcome.exit_code != 0
    assert "no run-id 99" in outcome.text


def test_list_runs_shows_name_status_and_counts(tmp_path, done) -> None:
    [outcome] = _both(tmp_path, [["list-runs", "-d", DB]], done)
    assert outcome.exit_code == 0
    assert "my synthetic run" in outcome.text
    assert "Done" in outcome.text
    assert "sourmash" in outcome.text
    assert re.search(r"\b9\b", outcome.text)  # 3 genomes -> 9 comparisons


def test_delete_run_requires_confirmation(tmp_path, done) -> None:
    """Without --force an interactive confirmation guards deletion;
    answering no leaves the run in place."""
    declined, unknown = _both(
        tmp_path,
        [["delete-run", "-d", DB], ["delete-run", "-d", DB, "--run-id", "99", "--force"]],
        done,
        stdin="n\n",
    )
    with TorchDatabase(tmp_path / "work" / "db.sqlite") as db:
        assert len(db.list_runs()) == 1  # still there
    assert "Delete run 1" in declined.text
    assert unknown.exit_code != 0  # unknown run id is an error


def test_resume_without_runs_errors(tmp_path) -> None:
    [outcome] = _both(tmp_path, [["resume", "-d", f"{WORK}/empty.sqlite"]], _empty_db)
    assert outcome.exit_code != 0


def test_resume_unknown_run_id_errors(tmp_path, done) -> None:
    [outcome] = _both(tmp_path, [["resume", "-d", DB, "--run-id", "42"]], done)
    assert outcome.exit_code != 0


def test_classify_cov_min_gates_edges(tmp_path, done) -> None:
    """At an impossible coverage floor no edges survive: every genome
    ends up alone (singleton rows only)."""
    [outcome] = _both(tmp_path, [["classify", "-d", DB, "-o", f"{WORK}/strict",
                                  "--cov-min", "1.1"]], done)  # fmt: skip
    assert outcome.exit_code == 0, outcome.text
    header, *rows = _table(outcome.tsvs["strict/sourmash_classify.tsv"])
    assert len(rows) == 3
    assert all(row[header.index("n_nodes")] == "1" for row in rows)


def test_classify_defaults_find_clique(tmp_path, done) -> None:
    """With default gates the two close relatives form a clique, and the
    far genome joins none."""
    [outcome] = _both(tmp_path, [["classify", "-d", DB, "-o", f"{WORK}/default"]], done)
    assert outcome.exit_code == 0, outcome.text
    header, *rows = _table(outcome.tsvs["default/sourmash_classify.tsv"])
    cliques = [row[-1] for row in rows if int(row[header.index("n_nodes")]) >= 2]
    assert cliques == ["genome_0,genome_1"], rows


def _table(lines: list[str]) -> list[list[str]]:
    """A classify TSV's sorted lines as rows, its header first."""
    rows = [line.split("\t") for line in lines if line.strip()]
    header = next(row for row in rows if "n_nodes" in row)
    return [header, *(row for row in rows if row is not header)]


def test_export_run_empty_outdir_created(tmp_path, done) -> None:
    """export-run creates the output directory when missing."""
    [outcome] = _both(tmp_path, [["export-run", "-d", DB, "-o", f"{WORK}/brand/new"]], done)
    assert outcome.exit_code == 0, outcome.text
    assert "brand/new/sourmash_run_1.tsv" in outcome.tsvs


def test_launch_requires_a_command(tmp_path) -> None:
    [outcome] = _both(tmp_path, [["launch", "-n", "2"]])
    assert outcome.exit_code != 0
    assert "No command given" in outcome.text


def test_version_flag(tmp_path) -> None:
    [outcome] = _both(tmp_path, [["--version"]])
    assert outcome.exit_code == 0
    assert __version__ in outcome.text


def test_plot_run_unknown_run_id_errors(tmp_path, done) -> None:
    [outcome] = _both(tmp_path, [["plot-run", "-d", DB, "-o", f"{WORK}/plots",
                                  "--run-id", "999"]], done)  # fmt: skip
    assert outcome.exit_code != 0


def test_plot_run_empty_db_errors(tmp_path) -> None:
    """plot-run on a database with no runs fails cleanly (no traceback
    dump to the user -- the reference's log_sys_exit contract)."""
    [outcome] = _both(tmp_path, [["plot-run", "-d", f"{WORK}/empty.sqlite", "-o",
                                  f"{WORK}/plots"]], _empty_db)  # fmt: skip
    assert outcome.exit_code != 0
    assert outcome.exception is None


def test_classify_unknown_run_id_errors(tmp_path, done) -> None:
    [outcome] = _both(tmp_path, [["classify", "-d", DB, "-o", f"{WORK}/cls",
                                  "--run-id", "999"]], done)  # fmt: skip
    assert outcome.exit_code != 0


def test_classify_all_null_run_yields_singletons(tmp_path) -> None:
    """classify over a run whose cross comparisons are all NULL (two
    unrelated random genomes under ANIm): NaN scores produce no edges, so
    the output degenerates to per-genome singletons -- the
    NULL-propagation contract end-to-end."""
    genomes = tmp_path / "random"
    genomes.mkdir()
    rng = np.random.default_rng(23)
    for idx in range(2):
        write_fasta(genomes / f"random_{idx}.fna", f"random_{idx}",
                    np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 5000)])  # fmt: skip

    def build(work: Path, tag: str) -> None:
        result = CliRunner().invoke(
            PACKAGES[tag][0], ["anim", str(genomes), "-d", str(work / "null.sqlite"),
                               "--create-db"], catch_exceptions=False,
        )  # fmt: skip
        assert result.exit_code == 0, result.output
        with sqlite3.connect(work / "null.sqlite") as conn:
            cross = conn.execute(
                "SELECT identity, aln_length FROM comparisons WHERE query_hash != subject_hash"
            ).fetchall()
        assert cross == [(None, None)] * 2, cross

    [outcome] = _both(tmp_path / "cases", [["classify", "-d", f"{WORK}/null.sqlite", "-o",
                                            f"{WORK}/cls"]], build)  # fmt: skip
    assert outcome.exit_code == 0, outcome.text
    header, *rows = _table(outcome.tsvs["cls/ANIm_classify.tsv"])
    # cross identities are NULL, so no multi-genome clique can form
    assert len(rows) == 2
    assert all(row[header.index("n_nodes")] == "1" for row in rows), rows
