"""The public CLI's flows over a sourmash run: the port against the JAX
package.

The counterpart of ``tests/test_public_cli.py``: the long-form export,
resume with nothing left to do, classify (identity and tANI, with and
without its plot), delete-run, plot-run, plot-run-comp, the export and
import of comparisons, resume with an input gone, export-run of an
incomplete run and of a chosen run id. The JAX file runs sourmash over
the reference's viral genomes; here it runs over three close relatives
of one synthetic ancestor (``synthetic.write_genome_dir``). Each case
gives each package in turn the same input at the same paths, a copy of
the package's own store where the case starts from one, and runs that
package's CLI: exit codes, the exception that ended a command, message
text (log time stamps, run dates, line breaks and the port's device lines
aside), the stored rows (integers exact, floats equal), every TSV written
and the names of every file written must agree, and the port must meet
the JAX case's own assertions.
"""

from __future__ import annotations

import json
import re
import shutil
import sqlite3
from pathlib import Path
from typing import Callable, NamedTuple

import pytest
from click.testing import CliRunner

from pyani_plus_tpu.cli.main import app as jax_app
from pyani_plus_tpu.db import Database as JaxDatabase
from pyani_plus_tpu_torch.cli.main import app as torch_app
from pyani_plus_tpu_torch.db import Database as TorchDatabase
from pyani_plus_tpu_torch.synthetic import write_genome_dir

PACKAGES = {"jax": (jax_app, JaxDatabase), "torch": (torch_app, TorchDatabase)}
WORK = "{work}"  # in an argument list: the case's working directory
DB = f"{WORK}/db.sqlite"  # the case's copy of the package's sourmash store


class Outcome(NamedTuple):
    exit_code: int
    exception: str | None  # the type of what ended the command, if not a clean exit
    text: str
    rows: list[tuple]  # every stored comparison of every store under the work directory
    tsvs: dict[str, list[str]]  # name -> sorted lines of every TSV under the work directory
    files: list[str]  # every file under the work directory


def _text(output: str) -> str:
    """The CLI's output without rich's time stamps, the runs' dates and
    line breaks, and without the lines only the port writes: its device
    probe, logged once a process, and the device its method runs on."""
    lines = [line for line in output.splitlines()
             if not re.search(r"INFO\s+(backend: |\S+ runs on (cpu|cuda))", line)]  # fmt: skip
    output = re.sub(r"\[\d\d/\d\d/\d\d \d\d:\d\d:\d\d\]", " ", "\n".join(lines))
    return " ".join(re.sub(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d", "DATE", output).split())


def _rows(work: Path) -> list[tuple]:
    rows = []
    for db in sorted(work.rglob("*.sqlite")):
        with sqlite3.connect(db) as conn:
            rows += conn.execute(
                "SELECT query_hash, subject_hash, identity, aln_length, sim_errors, cov_query,"
                " cov_subject, configuration_id FROM comparisons"
                " ORDER BY configuration_id, query_hash, subject_hash"
            ).fetchall()
    return rows


def _invoke(app, argv: list[str], work: Path) -> Outcome:
    result = CliRunner().invoke(app, [arg.replace(WORK, str(work)) for arg in argv], env={"COLUMNS": "400"})
    exception = result.exception
    kind = None if exception is None or isinstance(exception, SystemExit) else type(exception).__name__
    tsvs = {str(p.relative_to(work)): sorted(p.read_text().splitlines()) for p in sorted(work.rglob("*.tsv"))}
    files = sorted(str(p.relative_to(work)) for p in work.rglob("*") if p.is_file())
    return Outcome(result.exit_code, kind, _text(result.output), _rows(work), tsvs, files)


def _both(
    tmp_path: Path,
    commands: list[list[str]],
    build: Callable[[Path, str], None] | None = None,
    between: Callable[[Path, str, int], None] | None = None,
) -> list[Outcome]:
    """Give each package in turn a fresh working directory, ``build(work,
    tag)`` in it, then run ``commands`` through its CLI, with
    ``between(work, tag, index)`` after the command of that index; assert
    both agree and return the port's outcomes."""
    outcomes = {}
    work = tmp_path / "work"
    for tag, (app, _database) in PACKAGES.items():
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir()
        if build is not None:
            build(work, tag)
        outcomes[tag] = []
        for index, argv in enumerate(commands):
            outcomes[tag].append(_invoke(app, argv, work))
            if between is not None:
                between(work, tag, index)
    assert outcomes["torch"] == outcomes["jax"]
    return outcomes["torch"]


@pytest.fixture(scope="module")
def genomes(tmp_path_factory) -> Path:
    """Three 100 kb genomes of one ancestor at 0.2%, 0.4% and 0.6%
    substitutions: close enough for one clique of three."""
    directory = tmp_path_factory.mktemp("public_cli_genomes")
    write_genome_dir(directory, 100_000, [0.002, 0.004, 0.006], seed=19)
    return directory


def _sourmash(genomes: Path | str, db: str, scaled: str = "300", *extra: str) -> list[str]:
    return ["sourmash", str(genomes), "-d", db, "--scaled", scaled, "--cache", f"{WORK}/cache", *extra]


@pytest.fixture(scope="module")
def done_dbs(tmp_path_factory, genomes) -> dict[str, Path]:
    """One complete sourmash run at scaled 300, by each package's CLI."""
    tmp = tmp_path_factory.mktemp("public_cli")
    dbs = {}
    for tag, (app, _database) in PACKAGES.items():
        dbs[tag] = tmp / f"{tag}.sqlite"
        argv = [arg.replace(WORK, str(tmp)) for arg in _sourmash(genomes, str(dbs[tag]), "300", "--create-db")]
        result = CliRunner().invoke(app, argv, catch_exceptions=False)
        assert result.exit_code == 0, result.output
    return dbs


@pytest.fixture()
def done(done_dbs) -> Callable[[Path, str], None]:
    """``build`` for ``_both``: the package's sourmash store at ``DB``."""

    def build(work: Path, tag: str) -> None:
        shutil.copy(done_dbs[tag], work / "db.sqlite")

    return build


def _update(work: Path, *statements: str) -> None:
    with sqlite3.connect(work / "db.sqlite") as conn:
        for statement in statements:
            conn.execute(statement)


def test_export_long_form(tmp_path, done) -> None:
    [export] = _both(tmp_path, [["export-run", "-d", DB, "-o", f"{WORK}/out"]], done)
    assert export.exit_code == 0, export.text
    lines = (tmp_path / "work" / "out" / "sourmash_run_1.tsv").read_text().splitlines()
    assert lines[0].startswith("#Query\tSubject\tIdentity")
    assert len(lines) == 1 + 9  # header + 3 x 3 comparisons
    assert lines[1].split("\t")[7] == "NA"  # no alignment length for sourmash


def test_resume_noop_complete(tmp_path, done) -> None:
    [resume] = _both(tmp_path, [["resume", "-d", DB]], done)
    assert resume.exit_code == 0, resume.text
    assert "resumed" in resume.text
    assert len(resume.rows) == 9


@pytest.mark.parametrize(
    ("mode", "plot"),
    [("identity", False), ("tANI", False), ("identity", True)],
    ids=["identity", "tANI", "identity-plot"],
)
def test_classify(mode: str, plot: bool, tmp_path, done) -> None:
    """classify in each mode; with its plot, the stacked figure too."""
    argv = ["classify", "-d", DB, "-o", f"{WORK}/classify", "--mode", mode]
    [outcome] = _both(tmp_path, [[*argv, *([] if plot else ["--no-plot"])]], done)
    assert outcome.exit_code == 0, outcome.text
    table = [line.split("\t") for line in outcome.tsvs["classify/sourmash_classify.tsv"]]
    score = "-tANI" if mode == "tANI" else "identity"
    assert ["n_nodes", "max_cov", f"min_{score}", f"max_{score}", "members"] in table
    if mode == "identity":
        assert "3" in {row[0] for row in table}  # the three relatives form one clique
    assert ("classify/sourmash_classify_plot.png" in outcome.files) == plot


def test_delete_run(tmp_path, done) -> None:
    """delete-run --force drops the run and keeps its comparisons for reuse."""
    [delete] = _both(tmp_path, [["delete-run", "-d", DB, "--force"]], done)
    assert delete.exit_code == 0, delete.text
    with TorchDatabase(tmp_path / "work" / "db.sqlite") as db:
        assert db.list_runs() == []
    assert len(delete.rows) == 9


def test_plot_run(tmp_path, done) -> None:
    """plot-run writes the scatter, distribution and heatmap files under
    the reference's names."""
    [plot] = _both(tmp_path, [["plot-run", "-d", DB, "-o", f"{WORK}/plots", "--formats", "tsv,png"]], done)
    assert plot.exit_code == 0, plot.text
    for name in ("sourmash_identity_heatmap.png", "sourmash_identity_heatmap.tsv",
                 "sourmash_identity_dist.png", "sourmash_query_cov_scatter.png",
                 "sourmash_query_cov_scatter.tsv", "sourmash_tANI_scatter.png",
                 "sourmash_tANI_heatmap.png", "sourmash_hadamard_dist.png"):  # fmt: skip
        assert f"plots/{name}" in plot.files, name
    heatmap = plot.tsvs["plots/sourmash_identity_heatmap.tsv"]
    assert len(heatmap) == 4 and all(len(line.split("\t")) == 4 for line in heatmap)  # 3 x 3


def test_plot_run_comp(tmp_path, genomes, done) -> None:
    """A second run at another scale over the same genomes, then
    plot-run-comp: the scatter and difference grids and the per-pair TSV."""
    run, comp = _both(
        tmp_path,
        [_sourmash(genomes, DB, "200"),
         ["plot-run-comp", "-d", DB, "-o", f"{WORK}/comp", "--run-ids", "1,2", "--formats", "tsv,png"]],
        done,
    )  # fmt: skip
    assert run.exit_code == 0 and comp.exit_code == 0, run.text + comp.text
    assert len(run.rows) == 18
    assert "comp/sourmash_identity_1_scatter_vs_others.png" in comp.files
    assert "comp/sourmash_identity_1_diff_vs_others.png" in comp.files
    assert len(comp.tsvs["comp/sourmash_identity_1_vs_2.tsv"]) == 1 + 9  # every comparison in common


def test_export_import_comparisons_roundtrip(tmp_path, done) -> None:
    """export-comparisons writes the JSON batch; importing it twice into
    a store that holds the configuration and genomes adds 9 rows once."""
    payloads = {}

    def between(work: Path, tag: str, index: int) -> None:
        if index:
            return
        payload = payloads[tag] = json.loads((work / "batch.json").read_text())
        with PACKAGES[tag][1](work / "fresh.sqlite", create=True) as db:
            config = payload["configuration"]
            db.get_or_create_configuration(**{key: config.get(key) for key in (
                "method", "program", "version", "fragsize", "mode", "kmersize", "minmatch", "extra")})  # fmt: skip
            for comp in payload["comparisons"]:
                db.add_genome(comp["query_hash"], "x.fasta", 1, "seeded")

    imports = ["import-comparisons", "-d", f"{WORK}/fresh.sqlite", f"{WORK}/batch.json"]
    export, *imported = _both(tmp_path, [["export-comparisons", "-d", DB, "-o", f"{WORK}/batch.json"],
                                         imports, imports], done, between)  # fmt: skip
    assert payloads["torch"] == payloads["jax"]
    assert set(payloads["torch"]) == {"configuration", "uname", "comparisons"}
    assert len(payloads["torch"]["comparisons"]) == 9
    assert export.exit_code == 0 and all(outcome.exit_code == 0 for outcome in imported)
    with TorchDatabase(tmp_path / "work" / "fresh.sqlite") as db:
        assert db.conn.execute("SELECT COUNT(*) FROM comparisons").fetchone()[0] == 9


def test_resume_missing_fasta_errors(tmp_path, genomes) -> None:
    """resume checks that every input FASTA is still there."""

    def build(work: Path, _tag: str) -> None:
        shutil.copytree(genomes, work / "genomes")

    def between(work: Path, _tag: str, index: int) -> None:
        if index == 0:
            _update(work, "UPDATE runs SET status='Worker interrupted'")
            (work / "genomes" / "genome_1.fna").unlink()

    run, resume = _both(tmp_path, [_sourmash(f"{WORK}/genomes", DB, "300", "--create-db"),
                                   ["resume", "-d", DB]], build, between)  # fmt: skip
    assert run.exit_code == 0, run.text
    assert resume.exit_code != 0
    assert "Missing" in resume.text


def test_export_run_incomplete_errors(tmp_path, done) -> None:
    """export-run of a run with comparisons missing fails and writes no
    matrix."""

    def build(work: Path, tag: str) -> None:
        done(work, tag)
        _update(
            work,
            "DELETE FROM comparisons WHERE comparison_id IN"
            " (SELECT comparison_id FROM comparisons LIMIT 2)",
            "UPDATE runs SET status='Running'",
            "UPDATE runs SET df_identity=NULL, df_cov_query=NULL, df_aln_length=NULL,"
            " df_sim_errors=NULL, df_hadamard=NULL",
        )
        (work / "out").mkdir()

    [export] = _both(tmp_path, [["export-run", "-d", DB, "-o", f"{WORK}/out"]], build)
    assert export.exit_code != 0
    assert not [name for name in export.files if name.endswith("_identity.tsv")]


def test_export_run_selects_run_id(tmp_path, genomes, done) -> None:
    """--run-id exports that run, not the latest."""
    commands = [_sourmash(genomes, DB, "1000")] + [
        ["export-run", "-d", DB, "-o", f"{WORK}/out{run_id}", "--run-id", run_id] for run_id in ("1", "2")
    ]
    run, *exports = _both(tmp_path, commands, done)
    assert run.exit_code == 0 and all(export.exit_code == 0 for export in exports)
    tsvs = exports[-1].tsvs
    # scaled 300 and scaled 1000 give different containments
    assert tsvs["out1/sourmash_run_1.tsv"] != tsvs["out2/sourmash_run_2.tsv"]
