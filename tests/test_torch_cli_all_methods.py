"""Every method's CLI run, export and resume, and odd inputs: the port
against the JAX package.

The counterpart of ``tests/test_cli_all_methods.py``: the fast methods on
gzipped genomes, external-alignment's run and resume on a gap-padded
alignment, gzipped inputs with shell-hostile names, duplicate MD5s, a
compression that disagrees with the file's extension, two inputs with
one stem at export, sourmash's sketch cache reused, and resume from a
partial run for the two methods whose resume no other port test holds
(dnadiff and ANIb; ``tests/test_torch_cli.py`` and
``tests/test_torch_host_methods.py`` hold the rest). The JAX file reads
the reference's viral and bacterial genomes; here the genomes are
synthetic, from a seed (``synthetic.write_genome_dir``). Each case gives
each package in turn the same input at the same paths and runs that
package's CLI: exit codes, the exception that ended a command, message
text (log time stamps, run dates, line breaks and the port's line naming
its device aside), the stored rows (integers exact, floats equal) and
every TSV written must agree, and the port must meet the JAX case's own
assertions.
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

import pyani_plus_tpu.methods.sourmash as jax_sourmash
from pyani_plus_tpu.cli.main import app as jax_app
from pyani_plus_tpu.genomes import load_genome as jax_load_genome
from pyani_plus_tpu_torch.cli.main import app as torch_app
from pyani_plus_tpu_torch.db import Database
from pyani_plus_tpu_torch.genomes import decode_sequence, load_genome
from pyani_plus_tpu_torch.methods import sourmash
from pyani_plus_tpu_torch.synthetic import write_genome_dir

PACKAGES = {"jax": (jax_app, jax_sourmash), "torch": (torch_app, sourmash)}
WORK = "{work}"  # in an argument list: the case's working directory
DB = f"{WORK}/ani.db"


class Outcome(NamedTuple):
    exit_code: int
    exception: str | None  # the type of what ended the command, if not a clean exit
    text: str
    rows: list[tuple]  # every stored comparison of every store under the work directory
    tsvs: dict[str, list[str]]  # name -> sorted lines of every TSV under the work directory


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
    for db in sorted(work.rglob("*.db")):
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
    return Outcome(result.exit_code, kind, _text(result.output), _rows(work), tsvs)


def _both(
    tmp_path: Path,
    commands: list[list[str]],
    build: Callable[[Path, str], None] | None = None,
    between: Callable[[Path, int], None] | None = None,
) -> list[Outcome]:
    """Give each package in turn a fresh working directory, ``build(work,
    tag)`` in it, then run ``commands`` through its CLI, with
    ``between(work, index)`` after the command of that index; assert both
    agree and return the port's outcomes."""
    outcomes = {}
    work = tmp_path / "work"
    for tag, (app, _sourmash) in PACKAGES.items():
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        if build is not None:
            build(work, tag)
        outcomes[tag] = []
        for index, argv in enumerate(commands):
            outcomes[tag].append(_invoke(app, argv, work))
            if between is not None:
                between(work, index)
    assert outcomes["torch"] == outcomes["jax"]
    return outcomes["torch"]


@pytest.fixture(scope="module")
def genomes(tmp_path_factory) -> list[Path]:
    """Three 30 kb genomes of one ancestor at 1%, 3% and 6% substitutions."""
    return write_genome_dir(tmp_path_factory.mktemp("genomes"), 30_000, [0.01, 0.03, 0.06], seed=8)


def _copy(paths: list[Path], names: list[str], *, gz: bool = False) -> Callable[[Path, str], None]:
    """``build``: the genomes under new names in ``WORK/genomes``, gzipped if asked."""

    def build(work: Path, _tag: str) -> None:
        (work / "genomes").mkdir()
        for src, name in zip(paths, names):
            if gz:
                with src.open("rb") as fh, gzip.open(work / "genomes" / name, "wb") as out:
                    shutil.copyfileobj(fh, out)
            else:
                shutil.copy(src, work / "genomes" / name)

    return build


def _partial(count: int) -> Callable[[Path, int], None]:
    """``between``: after the first command, drop `count` comparisons and
    mark the run interrupted."""

    def between(work: Path, index: int) -> None:
        if index == 0:
            with sqlite3.connect(work / "ani.db") as conn:
                conn.execute(
                    "DELETE FROM comparisons WHERE comparison_id IN"
                    f" (SELECT comparison_id FROM comparisons LIMIT {count})"  # noqa: S608
                )
                conn.execute("UPDATE runs SET status='Worker interrupted'")

    return between


def _run(command: str, *extra: str) -> list[str]:
    return [command, f"{WORK}/genomes", "-d", DB, "--create-db", "--cache", f"{WORK}/cache", *extra]


def _status(work: Path) -> tuple[str, int]:
    with Database(work / "ani.db") as db:
        run = db.load_run()
        return run.status, run.comparisons_count()


@pytest.mark.parametrize(
    ("command", "extra"),
    [("sourmash", ["--scaled", "1000"]), ("fastani", []), ("skani", []), ("animinimap2", [])],
)
def test_cli_fast_methods_gzipped(command: str, extra: list[str], genomes, tmp_path) -> None:
    """The fast methods end to end on gzipped genomes, as on the JAX
    file's bacterial set, exported by stem."""
    names = [f"{p.stem}.fna.gz" for p in genomes]
    run, export = _both(tmp_path, [_run(command, *extra),
                                   ["export-run", "-d", DB, "-o", f"{WORK}/out", "--label", "stem"]],
                        _copy(genomes, names, gz=True))  # fmt: skip
    assert run.exit_code == 0 and export.exit_code == 0, run.text + export.text
    assert len(export.rows) == 9
    method = {"fastani": "fastANI", "animinimap2": "ANIminimap2"}.get(command, command)
    identity = export.tsvs[f"out/{method}_identity.tsv"]
    assert len(identity) == 4 and {line.split("\t")[0] for line in identity} == {"", *(p.stem for p in genomes)}


def test_cli_external_alignment_run_and_resume(genomes, tmp_path) -> None:
    """external-alignment on a mock alignment (each genome padded with
    gaps to the longest): a symmetric matrix with 1 on the diagonal; the
    alignment moved but unchanged is found by its MD5 on resume."""

    def build(work: Path, tag: str) -> None:
        _copy(genomes, [p.name for p in genomes])(work, tag)
        records = [load_genome(work / "genomes" / p.name) for p in genomes]
        longest = max(g.length for g in records)
        with (work / "genomes" / "mock.aln").open("w") as fh:
            for path, genome in zip(genomes, records):
                seq = decode_sequence(genome.records[0].codes).decode()
                fh.write(f">{path.stem}\n{seq}{'-' * (longest - len(seq))}\n")

    def between(work: Path, index: int) -> None:
        if index == 0:
            (work / "genomes" / "mock.aln").rename(work / "genomes" / "renamed-later.aln")
            _partial(3)(work, 0)

    run, resume = _both(
        tmp_path,
        [_run("external-alignment", "--alignment", f"{WORK}/genomes/mock.aln"), ["resume", "-d", DB]],
        build,
        between,
    )
    assert run.exit_code == 0 and resume.exit_code == 0, run.text + resume.text
    assert _status(tmp_path / "work") == ("Done", 9)
    assert len(run.rows) == 9 and resume.rows == run.rows
    with Database(tmp_path / "work" / "ani.db") as db:
        identity = db.load_run().identities.to_numpy()
    assert np.allclose(np.diag(identity), 1.0)
    assert np.allclose(identity, identity.T, equal_nan=True)


def test_cli_gzipped_and_evil_filenames(genomes, tmp_path) -> None:
    """Gzipped inputs with shell-hostile names run end to end."""
    names = ["with space.fasta.gz", "quo'te.fasta.gz", "semi;colon.fasta.gz"]
    [run] = _both(tmp_path, [_run("sourmash", "--scaled", "300")], _copy(genomes, names, gz=True))
    assert run.exit_code == 0, run.text
    assert _status(tmp_path / "work") == ("Done", 9)
    with Database(tmp_path / "work" / "ani.db") as db:
        run_ = db.load_run()
        labels = set(run_.relabelled_matrix(run_.identities, "filename").index)
    assert labels == set(names)


def test_cli_duplicate_md5_errors(genomes, tmp_path) -> None:
    [run] = _both(tmp_path, [_run("sourmash")], _copy([genomes[0]] * 2, ["a.fasta", "b.fasta"]))
    assert run.exit_code != 0
    assert "MD5" in run.text


def test_gzip_extension_mismatch_errors(genomes, tmp_path) -> None:
    """Compression must agree with the extension: ``load_genome`` of both
    packages raises the same errors, and a mismatched input fails a run."""
    sneaky = tmp_path / "sneaky.fasta"
    with gzip.open(sneaky, "wb") as fh:
        fh.write(b">x\nACGT\n")
    fake = tmp_path / "fake.fasta.gz"
    fake.write_bytes(b">x\nACGT\n")
    empty = tmp_path / "empty.fasta"
    empty.write_bytes(b"")
    bad_gz = tmp_path / "bad.fasta.gz"
    with gzip.open(bad_gz, "wb") as fh:
        fh.write(b"this is not fasta\n")
    for path, match in ((sneaky, "No .gz ending"), (fake, "NOT gzip compressed"),
                        (empty, "not recognised as a FASTA"), (bad_gz, "not recognised as a FASTA")):  # fmt: skip
        with pytest.raises(ValueError, match=match) as port:
            load_genome(path)
        with pytest.raises(ValueError, match=match) as jax:
            jax_load_genome(path)
        assert str(port.value) == str(jax.value)
    # a plain file of something else reads as an empty genome in both
    garbage = tmp_path / "garbage.fasta"
    garbage.write_bytes(b"this is not fasta\n")
    plain = load_genome(garbage)
    assert plain.length == 0 and plain.n_sequences == 0
    assert (plain.length, plain.n_sequences) == (jax_load_genome(garbage).length, jax_load_genome(garbage).n_sequences)

    def build(work: Path, tag: str) -> None:
        _copy(genomes[:1], ["good.fasta"])(work, tag)
        shutil.copy(fake, work / "genomes" / "fake.fasta.gz")

    [run] = _both(tmp_path / "cli", [_run("sourmash")], build)
    assert run.exit_code != 0


def test_cli_duplicate_stem_export_errors(genomes, tmp_path) -> None:
    """Two inputs sharing a stem fail a --label stem export."""
    run, export = _both(tmp_path, [_run("sourmash", "--scaled", "300"),
                                   ["export-run", "-d", DB, "-o", WORK, "--label", "stem"]],
                        _copy(genomes[:2], ["same.fasta", "same.fna"]))  # fmt: skip
    assert run.exit_code == 0, run.text
    assert export.exit_code != 0


def test_sourmash_sketch_cache_reused(genomes, tmp_path, monkeypatch) -> None:
    """Each genome's sketch is kept under (MD5, k, scaled) and reused: a
    second run over a warm cache never calls the sketching function."""

    def boom(*_args, **_kwargs):  # pragma: no cover - called means a cache miss
        msg = "sketch_genome called despite warm cache"
        raise AssertionError(msg)

    def between(work: Path, index: int) -> None:
        if index == 0:
            assert len(list((work / "cache" / "sourmash_k=31_scaled=300").glob("*.npy"))) == 3
            for _app, module in PACKAGES.values():
                monkeypatch.setattr(module, "sketch_genome", boom)
        else:
            monkeypatch.undo()

    second = _run("sourmash", "--scaled", "300")
    second[3] = f"{WORK}/second.db"
    first, warm = _both(tmp_path, [_run("sourmash", "--scaled", "300"), second],
                        _copy(genomes, [p.name for p in genomes]), between)  # fmt: skip
    assert first.exit_code == 0 and warm.exit_code == 0, warm.text
    with Database(tmp_path / "work" / "second.db") as db:
        assert db.load_run().status == "Done"


@pytest.mark.parametrize("command", ["dnadiff", "anib"])
def test_cli_run_export_resume(command: str, genomes, tmp_path) -> None:
    """Run, export, then resume after comparisons were dropped: Done with
    every row as it was, in both packages."""
    run, export, resume = _both(
        tmp_path,
        [_run(command), ["export-run", "-d", DB, "-o", f"{WORK}/out", "--label", "stem"],
         ["resume", "-d", DB]],
        _copy(genomes, [p.name for p in genomes]),
        lambda work, index: _partial(4)(work, 0) if index == 1 else None,
    )  # fmt: skip
    assert run.exit_code == export.exit_code == resume.exit_code == 0, resume.text
    assert len(export.rows) == 9 and resume.rows == export.rows
    assert _status(tmp_path / "work") == ("Done", 9)
