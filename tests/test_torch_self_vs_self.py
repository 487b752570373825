"""Self-vs-self comparisons: the port against the JAX package.

The counterpart of ``tests/test_self_vs_self.py``, case for case: one
genome alone in its directory through each method of both packages' CLIs,
the lone stored row equal between them (integers exact, floats equal),
and the port's identity as the JAX case asserts. The JAX file reads two
contigs of a real assembly; here ``synthetic.write_n_run_genome`` writes a
random genome of the first one's length (7,582 bp) with a 28-N run in its
middle, and ``synthetic.write_contigs_genome`` a genome of two random
contigs of 18,001 bp in all (the second one's length).
"""

from __future__ import annotations

import sqlite3
from pathlib import Path

import pytest
from click.testing import CliRunner

from pyani_plus_tpu.cli.main import app as jax_app
from pyani_plus_tpu_torch.cli.main import app as torch_app
from pyani_plus_tpu_torch.synthetic import write_contigs_genome, write_n_run_genome

APPS = {"jax": jax_app, "torch": torch_app}


def _self_identity(tmp_path: Path, genome: Path, method: str) -> float:
    """Run one method on the genome alone in both packages; the lone identity."""
    rows = {}
    for tag, app in APPS.items():
        db = tmp_path / f"{method}_{tag}.sqlite"
        result = CliRunner().invoke(
            app,
            [method, str(genome.parent), "-d", str(db), "--create-db", "--cache", str(tmp_path / tag)],
            catch_exceptions=False,
        )
        assert result.exit_code == 0, result.output
        with sqlite3.connect(db) as conn:
            rows[tag] = conn.execute(
                "SELECT identity, aln_length, sim_errors, cov_query, cov_subject FROM comparisons"
            ).fetchall()
    assert rows["torch"] == rows["jax"]
    [row] = rows["torch"]
    return row[0]


def test_self_vs_self_anim_n_run(tmp_path: Path) -> None:
    """A 28-N run: ANIm counts the N columns as errors, below 100%
    (1 - 28/7,582, the JAX case's value); every other method exactly 100%."""
    genome = tmp_path / "fasta" / "n_run.fasta"
    genome.parent.mkdir()
    write_n_run_genome(genome, 7582, seed=3)
    assert _self_identity(tmp_path, genome, "anim") == pytest.approx(0.9963070429965708, abs=1e-12)
    for method in ("dnadiff", "anib", "fastani", "sourmash"):
        assert _self_identity(tmp_path, genome, method) == 1.0, method


def test_self_vs_self_fastani_contig(tmp_path: Path) -> None:
    """Two contigs: the alignment methods and sourmash exactly 100%,
    fastANI at least as close to it as the reference binary (0.999953)."""
    genome = tmp_path / "fasta" / "two_contigs.fasta"
    genome.parent.mkdir()
    write_contigs_genome(genome, [10_000, 8_001], seed=6)
    for method in ("anim", "dnadiff", "anib", "sourmash"):
        assert _self_identity(tmp_path, genome, method) == 1.0, method
    assert 0.999953 <= _self_identity(tmp_path, genome, "fastani") <= 1.0
