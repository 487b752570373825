"""The four host-only methods through both CLIs, end to end on the CPU.

fastANI, skani, ANIminimap2 and external-alignment run on the host in the
JAX package (numpy, and C++ loaded by ctypes), and the port runs its own
copy of each. Both CLIs compute each method on the same synthetic genomes
(3 x 50 kb; external-alignment on their true alignment from
``synthetic.write_alignment``) into separate databases, and the
``export-run`` tables must be equal: integer matrices exact, floats
equal. A partial run of each method resumes under the port, and
external-alignment's error paths are driven on synthetic inputs.
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from click.testing import CliRunner

from pyani_plus_tpu.cli.main import app as jax_app
from pyani_plus_tpu_torch.cli.main import app as torch_app
from pyani_plus_tpu_torch.db import Database
from pyani_plus_tpu_torch.genomes import load_genome
from pyani_plus_tpu_torch.methods import ComputeContext, get_method
from pyani_plus_tpu_torch.synthetic import write_alignment

APPS = {"jax": jax_app, "torch": torch_app}
# command -> method name (the stem of its matrices' files)
METHODS = {
    "fastani": "fastANI",
    "skani": "skani",
    "animinimap2": "ANIminimap2",
    "external-alignment": "external-alignment",
}


@pytest.fixture(scope="module")
def genomes(tmp_path_factory) -> tuple[Path, Path]:
    """(genome directory, the genomes' alignment inside it)."""
    directory = tmp_path_factory.mktemp("host_method_genomes")
    _paths, alignment = write_alignment(directory, 50_000, [0.02, 0.08, 0.15], seed=7)
    return directory, alignment


def _invoke(app, args: list[str]):
    return CliRunner().invoke(app, args, catch_exceptions=False)


def _run_cli(app, args: list[str]) -> str:
    result = _invoke(app, args)
    assert result.exit_code == 0, result.output
    return result.output


def _run_args(command: str, genome_dir: Path, db: Path, alignment: Path, cache: Path) -> list[str]:
    extra = ["--alignment", str(alignment)] if command == "external-alignment" else []
    return [command, str(genome_dir), "-d", str(db), "--create-db", "--cache", str(cache), *extra]


def _read(path: Path) -> pd.DataFrame:
    frame = pd.read_csv(path, sep="\t", index_col=0)
    frame.index = frame.index.map(str)
    return frame.sort_index(axis=0).sort_index(axis=1)


def _rows(db: Path) -> dict[tuple[str, str], tuple]:
    with Database(db) as store:
        run = store.load_run()
        assert run.status == "Done" and run.comparisons_count() == 9
        return {
            (r["query_hash"], r["subject_hash"]): tuple(
                r[key] for key in ("identity", "aln_length", "sim_errors", "cov_query", "cov_subject")
            )
            for r in run.comparisons()
        }


@pytest.mark.parametrize("command", sorted(METHODS))
def test_cli_export_matches_jax(command: str, genomes: tuple[Path, Path], tmp_path: Path) -> None:
    genome_dir, alignment = genomes
    outdirs = {}
    for tag, app in APPS.items():
        db = tmp_path / f"{tag}.db"
        _run_cli(app, _run_args(command, genome_dir, db, alignment, tmp_path / f"cache_{tag}"))
        outdirs[tag] = tmp_path / f"out_{tag}"
        _run_cli(app, ["export-run", "-d", str(db), "-o", str(outdirs[tag])])
    method = METHODS[command]
    names = sorted(p.name for p in outdirs["jax"].glob("*.tsv"))
    assert names == sorted(p.name for p in outdirs["torch"].glob("*.tsv"))
    assert f"{method}_identity.tsv" in names and len(names) == 7
    for name in names:
        got, expected = (_read(outdirs[tag] / name) for tag in ("torch", "jax"))
        if name.endswith("_run_1.tsv"):  # long form, rows in completion order
            got, expected = (f.sort_values(list(f.columns)) for f in (got, expected))
        # exact: integers equal, floats equal (NaN where the method reports none)
        pd.testing.assert_frame_equal(got, expected, check_exact=True, obj=name)
    identity = _read(outdirs["torch"] / f"{method}_identity.tsv").to_numpy()
    assert identity.shape == (3, 3) and np.isfinite(identity.diagonal()).all()
    assert np.isfinite(identity[0, 1]) and identity[0, 1] < 1.0


@pytest.mark.parametrize("command", sorted(METHODS))
def test_port_resumes_a_partial_run(command: str, genomes: tuple[Path, Path], tmp_path: Path) -> None:
    """A run with comparisons missing completes under the port's
    ``resume`` with the rows it had (external-alignment finds its
    alignment beside the genomes, under the recorded name and MD5)."""
    genome_dir, alignment = genomes
    db = tmp_path / "ani.db"
    cache = ["--cache", str(tmp_path / "cache")]
    _run_cli(torch_app, _run_args(command, genome_dir, db, alignment, tmp_path / "cache"))
    before = _rows(db)
    with Database(db) as store:
        store.execute_with_retries(
            "DELETE FROM comparisons WHERE comparison_id IN"
            " (SELECT comparison_id FROM comparisons LIMIT 4)"
        )
        store.execute_with_retries("UPDATE runs SET status='Worker interrupted'")
        assert store.load_run().comparisons_count() == 5
    _run_cli(torch_app, ["resume", "-d", str(db), *cache])
    assert _rows(db) == before


# ------------------------------------------- external-alignment's errors


@pytest.fixture
def msa(genomes: tuple[Path, Path], tmp_path: Path) -> tuple[Path, Path, list[bytes]]:
    """A private copy of the genomes (alignment not among them), the
    alignment elsewhere, and the alignment's lines."""
    genome_dir, alignment = genomes
    copy = tmp_path / "genomes"
    copy.mkdir()
    for path in genome_dir.glob("*.fna"):
        shutil.copy(path, copy / path.name)
    moved = tmp_path / "original" / "msa.fasta"
    moved.parent.mkdir()
    shutil.copy(alignment, moved)
    return copy, moved, alignment.read_bytes().splitlines()


def _external(genome_dir: Path, alignment: Path, db: Path):
    return _invoke(torch_app, ["external-alignment", str(genome_dir), "-d", str(db),
                               "--create-db", "--alignment", str(alignment)])  # fmt: skip


def _interrupt(db: Path) -> None:
    with Database(db) as store:
        store.execute_with_retries("DELETE FROM comparisons WHERE query_hash != subject_hash")
        store.execute_with_retries("UPDATE runs SET status='Worker interrupted'")


def test_external_alignment_md5_mismatch_on_resume(msa, tmp_path: Path) -> None:
    """An alignment whose content changed since the run was logged is not
    taken on resume, beside the genomes or where it was given."""
    genome_dir, alignment, _lines = msa
    in_place = genome_dir / "msa.fasta.aln"
    shutil.copy(alignment, in_place)
    db = tmp_path / "ani.db"
    assert _external(genome_dir, in_place, db).exit_code == 0
    with Database(db) as store:
        extra = store.load_run().configuration.extra
    assert f"alignment={in_place.name}" in extra and "md5=" in extra
    _interrupt(db)
    in_place.write_bytes(in_place.read_bytes().replace(b"ACGT", b"TGCA", 1))
    result = _invoke(torch_app, ["resume", "-d", str(db)])
    assert result.exit_code != 0
    assert f"Cannot locate external alignment file '{in_place.name}'" in result.output
    # handed the changed file directly, the method refuses it by its MD5
    with Database(db) as store:
        run = store.load_run()
        genomes = {h: load_genome(genome_dir / name, h) for h, name in run.hash_to_filename.items()}
        extra = run.configuration.extra
    hashes = sorted(genomes)
    ctx = ComputeContext(
        logger=logging.getLogger(__name__), genomes=genomes, query_hashes=hashes,
        subject_hashes=hashes, pending={(hashes[0], hashes[1])},
        config={"method": "external-alignment", "extra": extra},
        extra_files={"alignment": in_place},
    )  # fmt: skip
    with pytest.raises(SystemExit, match="does not match configuration"):
        get_method("external-alignment").compute(ctx)


def test_external_alignment_unmappable_name(msa, tmp_path: Path) -> None:
    genome_dir, alignment, lines = msa
    alignment.write_bytes(b"\n".join([b">unknown-genome", *lines[1:]]) + b"\n")
    result = _external(genome_dir, alignment, tmp_path / "ani.db")
    assert result.exit_code != 0
    assert "Could not map unknown-genome as stem" in result.output


def test_external_alignment_length_mismatch(msa, tmp_path: Path) -> None:
    genome_dir, alignment, lines = msa
    last = max(i for i, line in enumerate(lines) if not line.startswith(b">"))
    lines[last] = lines[last] + b"ACG"
    alignment.write_bytes(b"\n".join(lines) + b"\n")
    result = _external(genome_dir, alignment, tmp_path / "ani.db")
    assert result.exit_code != 0
    assert "Bad external-alignment, different lengths" in result.output


def test_external_alignment_missing_genome(msa, tmp_path: Path) -> None:
    genome_dir, alignment, lines = msa
    starts = [i for i, line in enumerate(lines) if line.startswith(b">")]
    alignment.write_bytes(b"\n".join(lines[: starts[-1]]) + b"\n")  # drop the last row
    result = _external(genome_dir, alignment, tmp_path / "ani.db")
    assert result.exit_code != 0
    assert "Did not find" in result.output and alignment.name in result.output


def test_external_alignment_moved_is_found_by_md5(msa, tmp_path: Path) -> None:
    """A moved but unchanged alignment is found again by its recorded MD5
    among the files beside the genomes, under any name."""
    genome_dir, alignment, _lines = msa
    db = tmp_path / "ani.db"
    assert _external(genome_dir, alignment, db).exit_code == 0
    before = _rows(db)
    _interrupt(db)
    alignment.rename(genome_dir / "renamed.aln")
    _run_cli(torch_app, ["resume", "-d", str(db)])
    assert _rows(db) == before
