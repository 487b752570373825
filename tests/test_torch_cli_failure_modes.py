"""The port's CLI failure modes against the JAX package's.

The counterpart of ``tests/test_cli_failure_modes.py``, case for case:
bad FASTA-directory inputs, missing and empty databases, runs without
comparisons, a resume whose recorded tool version differs, for every
method, NULL comparisons through plots and classify, and plot-run-comp's
failures. Each case gives each package in turn the same input at the
same paths, made with that package's own CLI or ``Database``, and runs
that package's CLI. The two must agree on the exit code, on the exception
that ended the command, on the message text (log time stamps, dates,
line breaks and the port's line naming its device aside) and on every TSV
written; the port must also meet the JAX test's own assertions.

The JAX file's NULL cases read the reference's ``bad_alignments`` pair;
here ANIm runs over two unrelated random genomes made from a seed, whose
cross comparisons are NULL (``null_dbs`` asserts it).
"""

from __future__ import annotations

import gzip
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
from pyani_plus_tpu_torch.cli.main import app as torch_app
from pyani_plus_tpu_torch.db import Database as TorchDatabase
from pyani_plus_tpu_torch.synthetic import write_fasta

PACKAGES = {"jax": (jax_app, JaxDatabase), "torch": (torch_app, TorchDatabase)}
WORK = "{work}"  # in an argument list: the case's working directory


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


def _invoke(app, argv: list[str], work: Path) -> tuple:
    result = CliRunner().invoke(
        app, [arg.replace(WORK, str(work)) for arg in argv], env={"COLUMNS": "400"}
    )
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
) -> list[Outcome]:
    """Give each package in turn a fresh working directory, ``build(work,
    tag)`` in it, then run ``commands`` through its CLI; assert both agree
    and return the port's outcomes (the TSVs as they stand after each)."""
    outcomes = {}
    work = tmp_path / "work"
    for tag, (app, _database) in PACKAGES.items():
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir()
        if build is not None:
            build(work, tag)
        outcomes[tag] = [Outcome(*_invoke(app, argv, work), _tsvs(work)) for argv in commands]
    assert outcomes["torch"] == outcomes["jax"]
    return outcomes["torch"]


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory) -> Path:
    """Two tiny related genomes: every method completes in seconds."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, 2400)
    bases = np.array(list("ACGT"))
    d = tmp_path_factory.mktemp("tiny_genomes")
    for i in range(2):
        codes = base.copy()
        mut = rng.random(codes.size) < 0.02 * i
        codes[mut] = (codes[mut] + 1) % 4
        (d / f"t{i}.fasta").write_text(f">t{i}\n" + "".join(bases[codes]) + "\n")
    return d


# ---------------------------------------------------------------- inputs


def test_broken_symlink_input_errors(tmp_path) -> None:
    def build(work: Path, _tag: str) -> None:
        (work / "genomes").mkdir()
        (work / "genomes" / "broken.fa").symlink_to("/does/not/exist/example.fna")

    [outcome] = _both(tmp_path, [["sourmash", f"{WORK}/genomes", "-d", f"{WORK}/x.db",
                                  "--create-db"]], build)  # fmt: skip
    assert outcome.exit_code != 0
    assert "broken symlink" in outcome.text


def test_fasta_path_is_a_file_errors(tmp_path) -> None:
    def build(work: Path, _tag: str) -> None:
        (work / "not_a_dir.fasta").write_text(">x\nACGT\n")

    [outcome] = _both(tmp_path, [["sourmash", f"{WORK}/not_a_dir.fasta", "-d",
                                  f"{WORK}/x.db", "--create-db"]], build)  # fmt: skip
    assert outcome.exit_code != 0
    # click's path validation rejects it before our own check can
    assert "is a file" in outcome.text or "is not a directory" in outcome.text


def test_empty_fasta_directory_errors(tmp_path) -> None:
    def build(work: Path, _tag: str) -> None:
        (work / "empty").mkdir()

    [outcome] = _both(tmp_path, [["anim", f"{WORK}/empty", "-d", f"{WORK}/x.db",
                                  "--create-db"]], build)  # fmt: skip
    assert outcome.exit_code != 0
    assert "No FASTA input genomes" in outcome.text


@pytest.mark.parametrize("gz", [False, True])
def test_empty_fasta_file_errors(tmp_path, gz) -> None:
    """An empty FASTA file (plain or gzipped) is rejected at ingest
    (reference test_anim_fasta_empty / test_anim_fasta_gz_empty)."""

    def build(work: Path, _tag: str) -> None:
        d = work / "with_empty"
        d.mkdir()
        if gz:
            with gzip.open(d / "empty.fasta.gz", "wb"):
                pass
        else:
            (d / "empty.fasta").touch()

    [outcome] = _both(tmp_path, [["anim", f"{WORK}/with_empty", "-d", f"{WORK}/x.db",
                                  "--create-db"]], build)  # fmt: skip
    assert outcome.exit_code != 0
    assert "not recognised as a FASTA record" in outcome.text


# ------------------------------------------------- empty/missing-db paths


@pytest.mark.parametrize(
    "args",
    [
        ["delete-run", "--force"],
        ["resume"],
        ["export-run", "-o", f"{WORK}/out"],
        ["plot-run", "-o", f"{WORK}/out"],
        ["list-runs"],
    ],
)
def test_missing_database_errors(tmp_path, args) -> None:
    [outcome] = _both(tmp_path, [[*args, "-d", "/does/not/exist"]])
    assert outcome.exit_code != 0
    assert "does not exist" in outcome.text


def _empty_db(work: Path, tag: str) -> None:
    PACKAGES[tag][1](work / "empty.sqlite", create=True).close()


@pytest.mark.parametrize(
    "args",
    [
        ["delete-run", "--force"],
        ["resume"],
        ["export-run", "-o", f"{WORK}/out"],
        ["plot-run", "-o", f"{WORK}/out"],
    ],
)
def test_no_runs_database_errors(tmp_path, args) -> None:
    argv = [*args, "-d", f"{WORK}/empty.sqlite"]
    no_runs, no_id = _both(tmp_path, [argv, [*argv, "--run-id", "1"]], _empty_db)
    assert no_runs.exit_code != 0
    assert "contains no runs" in no_runs.text
    # unknown explicit run id on the same empty database
    assert no_id.exit_code != 0
    assert "has no run-id 1" in no_id.text


def test_run_with_no_comparisons_export_and_plot(tmp_path) -> None:
    """Runs that never computed anything fail export/plot with the
    reference's message (test_export_run_failures / test_plot_run_failures):
    unknown id first, then an explicit empty run, then the default latest."""

    def build(work: Path, tag: str) -> None:
        db = PACKAGES[tag][1](work / "noruns.sqlite", create=True)
        cfg = db.get_or_create_configuration("fastANI", "fastani", "1.2.3")
        for name in ("Trial A", "Trial B"):
            db.add_run(cfg.configuration_id, "pyani fastani ...", "/does/not/exist",
                       "Empty", name, [])  # fmt: skip
        db.close()

    commands = [
        [cmd, "-d", f"{WORK}/noruns.sqlite", "-o", f"{WORK}/out", *run_id]
        for cmd in ("export-run", "plot-run")
        for run_id in (["--run-id", "3"], ["--run-id", "1"], [])  # [] defaults to the latest (2)
    ]
    outcomes = _both(tmp_path, commands, build)
    for index in (0, 3):
        assert outcomes[index].exit_code != 0
        assert "has no run-id 3" in outcomes[index].text
    for index in (1, 2, 4, 5):
        assert outcomes[index].exit_code != 0
        assert "no comparisons" in outcomes[index].text


# --------------------------------------------- per-method version mismatch


@pytest.mark.parametrize("method", ["anim", "anib", "fastani", "animinimap2", "skani", "sourmash"])
def test_resume_version_mismatch_every_method(tiny_dir, tmp_path, method) -> None:
    """Resume re-validates the recorded program version per method
    (reference test_resume_partial_* family checks this for each)."""

    def build(work: Path, tag: str) -> None:
        result = CliRunner().invoke(
            PACKAGES[tag][0],
            [method, str(tiny_dir), "-d", str(work / "v.db"), "--create-db",
             "--cache", str(work)],  # fmt: skip
            catch_exceptions=False,
        )
        assert result.exit_code == 0, result.output
        with sqlite3.connect(work / "v.db") as conn:
            conn.execute("UPDATE configurations SET version = '0.0.0-other'")

    [outcome] = _both(tmp_path, [["resume", "-d", f"{WORK}/v.db"]], build)
    assert outcome.exit_code != 0
    assert "version" in outcome.text
    assert "cannot" in outcome.text.lower() or "resume" in outcome.text


# ----------------------------------------------------- nulls through plots


@pytest.fixture(scope="module")
def null_dbs(tmp_path_factory) -> dict[str, Path]:
    """ANIm over two unrelated random genomes, by each package's CLI: the
    cross comparisons are NULL (the reference's bad_alignments pair)."""
    tmp = tmp_path_factory.mktemp("nulls")
    genomes = tmp / "genomes"
    genomes.mkdir()
    rng = np.random.default_rng(11)
    for idx in range(2):
        write_fasta(genomes / f"random_{idx}.fna", f"random_{idx}",
                    np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 5000)])  # fmt: skip
    dbs = {}
    for tag, (app, _database) in PACKAGES.items():
        dbs[tag] = tmp / f"nulls_{tag}.db"
        result = CliRunner().invoke(
            app, ["anim", str(genomes), "-d", str(dbs[tag]), "--create-db"],
            catch_exceptions=False,
        )  # fmt: skip
        assert result.exit_code == 0, result.output
        with sqlite3.connect(dbs[tag]) as conn:
            rows = conn.execute(
                "SELECT query_hash = subject_hash, identity, aln_length, cov_query"
                " FROM comparisons"
            ).fetchall()
        cross = [row[1:] for row in rows if not row[0]]
        assert cross == [(None, None, None)] * 2, rows
        assert [row[1] for row in rows if row[0]] == [1.0] * 2, rows
    return dbs


def _copy_null_db(null_dbs: dict[str, Path]) -> Callable[[Path, str], None]:
    def build(work: Path, tag: str) -> None:
        shutil.copy(null_dbs[tag], work / "nulls.db")

    return build


def test_plot_run_with_null_comparisons(null_dbs, tmp_path) -> None:
    """Null comparisons plot with a warning, not a crash (reference
    test_plot_skip_nulls): heatmaps/distributions still produced."""
    [outcome] = _both(tmp_path, [["plot-run", "-d", f"{WORK}/nulls.db", "-o", f"{WORK}/plots"]],
                      _copy_null_db(null_dbs))  # fmt: skip
    assert outcome.exit_code == 0, outcome.text
    assert "null" in outcome.text.lower()
    assert "plots/ANIm_identity_heatmap.tsv" in outcome.tsvs
    assert (tmp_path / "work" / "plots" / "ANIm_identity_dist.png").is_file()


def test_classify_with_null_coverage(null_dbs, tmp_path) -> None:
    """classify on a run whose cross comparisons are NULL: no edges, one
    singleton clique per genome (reference test_classify_warnings)."""
    [outcome] = _both(tmp_path, [["classify", "-d", f"{WORK}/nulls.db", "-o", f"{WORK}/cls"]],
                      _copy_null_db(null_dbs))  # fmt: skip
    assert outcome.exit_code == 0, outcome.text
    lines = outcome.tsvs["cls/ANIm_classify.tsv"]
    # header + one singleton row per genome
    rows = [ln for ln in lines if ln.strip() and not ln.startswith("n_nodes")]
    assert len(rows) >= 2, lines


# ------------------------------------------------------ plot-run-comp tail


def test_plot_run_comp_failures(tmp_path) -> None:
    missing, empty = _both(
        tmp_path,
        [
            ["plot-run-comp", "-d", "/does/not/exist", "-o", f"{WORK}/out", "1,2"],
            ["plot-run-comp", "-d", f"{WORK}/empty.sqlite", "-o", f"{WORK}/out", "1,2"],
        ],
        _empty_db,
    )
    assert missing.exit_code != 0
    assert "does not exist" in missing.text
    assert empty.exit_code != 0
    assert "run-id" in empty.text or "contains no runs" in empty.text


def test_plot_run_invalid_format_errors(null_dbs, tmp_path) -> None:
    """--formats entries are validated against GRAPHICS_FORMATS at the
    CLI (clean CRITICAL + exit, not a matplotlib traceback)."""
    [outcome] = _both(tmp_path, [["plot-run", "-d", f"{WORK}/nulls.db", "-o", f"{WORK}/plots",
                                  "--formats", "png,bogus"]], _copy_null_db(null_dbs))  # fmt: skip
    assert outcome.exit_code != 0
    assert "Unsupported plot format" in outcome.text
    assert "bogus" in outcome.text


def test_delete_run_by_id_keeps_other_runs(tiny_dir, tmp_path) -> None:
    """delete-run --run-id removes one run; the other survives with its
    cached matrices (comparisons are content-addressed and shared)."""

    def build(work: Path, tag: str) -> None:
        for _ in range(2):
            result = CliRunner().invoke(
                PACKAGES[tag][0],
                ["sourmash", str(tiny_dir), "-d", str(work / "two.db"), "--create-db",
                 "--cache", str(work)],  # fmt: skip
                catch_exceptions=False,
            )
            assert result.exit_code == 0, result.output

    db = ["-d", f"{WORK}/two.db"]
    deleted, _listed, exported = _both(
        tmp_path,
        [
            ["delete-run", *db, "--run-id", "1", "--force"],
            ["list-runs", *db],
            ["export-run", *db, "-o", f"{WORK}/export2", "--run-id", "2"],
        ],
        build,
    )
    assert deleted.exit_code == 0, deleted.text
    assert "sourm" in _listed.text  # rich may ellipsise the column
    assert exported.exit_code == 0, exported.text
    assert "export2/sourmash_identity.tsv" in exported.tsvs


def test_classify_tani_mode_with_nulls(null_dbs, tmp_path) -> None:
    """classify --mode tANI on a run with NULL cross comparisons: NaN
    propagates through -ln(hadamard) and the nulls stay edge-less."""
    [outcome] = _both(tmp_path, [["classify", "-d", f"{WORK}/nulls.db", "-o",
                                  f"{WORK}/cls_tani", "--mode", "tANI"]],
                      _copy_null_db(null_dbs))  # fmt: skip
    assert outcome.exit_code == 0, outcome.text
    assert "cls_tani/ANIm_classify.tsv" in outcome.tsvs
