"""NULL comparisons end to end: the port against the JAX package.

The counterpart of ``tests/test_bad_alignments_e2e.py``: a pair of genomes
with no homology through every method of both packages' CLIs. The JAX
file reads the reference's ``bad_alignments`` pair; here
``synthetic.write_null_pair`` writes two unrelated random genomes of 40 kb
under the same stems. The stored rows must be equal (integers exact,
floats equal) and so must every TSV that ``export-run`` writes; the port
must store the cross comparisons as NULL and score each genome against
itself above 0.99, as the JAX case asserts.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

from pyani_plus_tpu.cli.main import app as jax_app
from pyani_plus_tpu_torch.cli.main import app as torch_app
from pyani_plus_tpu_torch.db import Database
from pyani_plus_tpu_torch.synthetic import NULL_PAIR_STEMS, write_null_pair

APPS = {"jax": jax_app, "torch": torch_app}
METHODS = ["anim", "dnadiff", "sourmash", "anib", "fastani", "animinimap2", "skani"]
STEMS = list(NULL_PAIR_STEMS)


@pytest.fixture(scope="module")
def null_dir(tmp_path_factory) -> Path:
    directory = tmp_path_factory.mktemp("null_pair")
    write_null_pair(directory, 40_000, seed=2)
    return directory


def _run(app, genomes: Path, method: str, work: Path) -> tuple[list[tuple], dict[str, list[str]]]:
    """(stored rows, export-run's files -> sorted lines) of one CLI run."""
    db = work / "ani.db"
    for args in (
        [method, str(genomes), "-d", str(db), "--create-db", "--cache", str(work)],
        ["export-run", "-d", str(db), "-o", str(work / "out")],
    ):
        result = CliRunner().invoke(app, args, catch_exceptions=False)
        assert result.exit_code == 0, result.output
    with sqlite3.connect(db) as conn:
        rows = conn.execute(
            "SELECT query_hash, subject_hash, identity, aln_length, sim_errors, cov_query,"
            " cov_subject FROM comparisons ORDER BY query_hash, subject_hash"
        ).fetchall()
    return rows, {p.name: sorted(p.read_text().splitlines()) for p in sorted((work / "out").glob("*.tsv"))}


@pytest.mark.parametrize("method", METHODS)
def test_null_pair_through_method(method: str, null_dir: Path, tmp_path: Path) -> None:
    runs = {}
    for tag, app in APPS.items():
        (tmp_path / tag).mkdir()
        runs[tag] = _run(app, null_dir, method, tmp_path / tag)
    assert runs["torch"] == runs["jax"]
    rows, tsvs = runs["torch"]
    assert len(rows) == 4 and len(tsvs) == 7
    with Database(tmp_path / "torch" / "ani.db") as db:
        run = db.load_run(check_complete=True)
        identity = run.relabelled_matrix(run.identities, "stem").loc[STEMS, STEMS].to_numpy()
    # cross comparisons are NULL rows: every value empty
    assert np.isnan(identity[0, 1]) and np.isnan(identity[1, 0]), method
    cross = [row[2:] for row in rows if row[0] != row[1]]
    assert cross == [(None, None, None, None, None)] * 2, cross
    # self comparisons are (near) perfect
    assert identity[0, 0] > 0.99 and identity[1, 1] > 0.99, method
