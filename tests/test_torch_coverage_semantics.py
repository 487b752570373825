"""Coverage and identity accounting on multi-contig genomes: the port
against the JAX package.

The counterpart of ``tests/test_coverage_semantics.py``, case for case,
extended to skani and ANIminimap2, and of ``tests/test_anim.py``'s
per-sequence filter case. The JAX file reads two contigs of a real
assembly from the reference's fixtures; here
``synthetic.write_coverage_set`` writes random contigs of the same
lengths (7,582 bp with a 28-N run, and 18,001 bp) as ``small.fasta``,
``large.fasta`` and ``both.fasta`` (the two records in one file). Each
method runs through both packages' CLIs over the set: the stored rows must
be equal (integers exact, floats equal) and so must every TSV that
``export-run`` writes; the port's matrices must then meet the JAX case's
own pattern. A divergent pair of two-contig genomes
(``synthetic.write_contig_pair``) gives ANIm and dnadiff extension tails
that end at contig ends; it runs the same way, and with the port's
batched plain paths forced (``PYANI_TPU_EXTEND_BATCH_MIN=1``,
``PYANI_TPU_ANIB_DEVICE=1``) together with the coverage set.
"""

from __future__ import annotations

import dataclasses
import sqlite3
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import pyani_plus_tpu.methods.anim as jax_anim
import pyani_plus_tpu.methods.dnadiff as jax_dnadiff
from pyani_plus_tpu.cli.main import app as jax_app
from pyani_plus_tpu.db import Database as JaxDatabase
from pyani_plus_tpu.genomes import load_genome as jax_load_genome
from pyani_plus_tpu_torch.cli.main import app as torch_app
from pyani_plus_tpu_torch.db import Database as TorchDatabase
from pyani_plus_tpu_torch.genomes import load_genome
from pyani_plus_tpu_torch.methods import anim, dnadiff
from pyani_plus_tpu_torch.ops import extend, sw
from pyani_plus_tpu_torch.synthetic import (
    COVERAGE_CONTIGS,
    write_contig_pair,
    write_coverage_set,
    write_multi_fasta,
)

PACKAGES = {"jax": (jax_app, JaxDatabase), "torch": (torch_app, TorchDatabase)}
ORDER = ["small", "both", "large"]
NAN = float("nan")
SMALL, LARGE = COVERAGE_CONTIGS["small"], COVERAGE_CONTIGS["large"]
# The alignment methods' coverage: the small query is covered whole or
# not at all; "both" covers itself whole and each single contig by its
# length (7,582 and 18,001 of 25,583 bp).
COV_BP = [
    [1.0, 1.0, NAN],
    [SMALL / (SMALL + LARGE), 1.0, LARGE / (SMALL + LARGE)],
    [NAN, 1.0, 1.0],
]
ONES = [[1.0, 1.0, NAN], [1.0, 1.0, 1.0], [NAN, 1.0, 1.0]]
# The JAX case's pinned values, which these contigs meet as the
# reference's do: 28 N-vs-N columns count as errors in ANIm,
# 1 - 28/7,582 and 1 - 28/25,583.
ANIM_IDENTITY = [
    [0.996307043, 0.996307043, NAN],
    [0.996307043, 0.9989055232, 1.0],
    [NAN, 1.0, 1.0],
]
EXTRA = {
    "fastani": ["--kmersize", "15", "--fragsize", "2000", "--minmatch", "0.15"],
    "sourmash": ["--scaled", "50"],
}


class Run(NamedTuple):
    rows: list[tuple]  # every stored comparison, by (query, subject)
    tsvs: dict[str, list[str]]  # each file export-run wrote -> its sorted lines
    identity: np.ndarray  # stem-labelled, rows and columns in `order`
    coverage: np.ndarray


def _run(tag: str, genomes: Path, method: str, work: Path, order: list[str]) -> Run:
    app, database = PACKAGES[tag]
    work.mkdir(parents=True)
    db = work / "ani.db"
    for args in (
        [method, str(genomes), "-d", str(db), "--create-db", "--cache", str(work), *EXTRA.get(method, [])],
        ["export-run", "-d", str(db), "-o", str(work / "out")],
    ):
        result = CliRunner().invoke(app, args, catch_exceptions=False)
        assert result.exit_code == 0, result.output
    with sqlite3.connect(db) as conn:
        rows = conn.execute(
            "SELECT query_hash, subject_hash, identity, aln_length, sim_errors, cov_query,"
            " cov_subject FROM comparisons ORDER BY query_hash, subject_hash"
        ).fetchall()
    with database(db) as store:
        run = store.load_run(check_complete=True)
        identity = run.relabelled_matrix(run.identities, "stem").loc[order, order].to_numpy()
        coverage = run.relabelled_matrix(run.cov_query, "stem").loc[order, order].to_numpy()
    tsvs = {path.name: sorted(path.read_text().splitlines()) for path in sorted((work / "out").glob("*.tsv"))}
    return Run(rows, tsvs, identity, coverage)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> dict[str, tuple[Path, list[str]]]:
    """Input name -> (its genome directory, the stems in matrix order)."""
    root = tmp_path_factory.mktemp("coverage")
    write_coverage_set(root / "coverage", seed=1)
    write_contig_pair(root / "contigs", seed=4)
    return {"coverage": (root / "coverage", ORDER), "contigs": (root / "contigs", ["contigs", "contigs_mutated"])}


@pytest.fixture(scope="module")
def jax_runs(inputs, tmp_path_factory) -> dict:
    """The JAX package's run of (input, method), made once when first asked."""
    root = tmp_path_factory.mktemp("jax_runs")
    cache: dict[tuple[str, str], Run] = {}

    def get(name: str, method: str) -> Run:
        if (name, method) not in cache:
            genomes, order = inputs[name]
            cache[name, method] = _run("jax", genomes, method, root / f"{name}_{method}", order)
        return cache[name, method]

    return get


def _port_equals_jax(inputs, jax_runs, tmp_path: Path, name: str, method: str) -> Run:
    genomes, order = inputs[name]
    port = _run("torch", genomes, method, tmp_path / name, order)
    expected = jax_runs(name, method)
    assert port.rows == expected.rows
    assert port.tsvs == expected.tsvs
    assert len(port.tsvs) == 7
    return port


def _check(got: np.ndarray, want: list[list[float]], atol: float = 5e-10) -> None:
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _null_crosses(matrix: np.ndarray) -> None:
    """small and large share nothing: NULL both ways, every other cell a number."""
    assert np.isnan(matrix[0, 2]) and np.isnan(matrix[2, 0])
    mask = np.ones_like(matrix, dtype=bool)
    mask[0, 2] = mask[2, 0] = False
    assert np.isfinite(matrix[mask]).all(), matrix


@pytest.mark.parametrize("method", ["anim", "dnadiff", "anib", "fastani", "sourmash", "skani", "animinimap2"])
def test_coverage_pattern(method: str, inputs, jax_runs, tmp_path: Path) -> None:
    """Each method over the coverage set; then the JAX case's pattern (the
    reference pins none for skani and ANIminimap2: NULL where the contigs
    differ, near 1 where the query is contained)."""
    port = _port_equals_jax(inputs, jax_runs, tmp_path, "coverage", method)
    identity, cov = port.identity, port.coverage
    if method == "anim":
        _check(identity, ANIM_IDENTITY)
        _check(cov, COV_BP)
    elif method in ("dnadiff", "anib"):
        # the N run is crossed and counted as identity, so the fragment
        # holding it keeps its full coverage under ANIb
        _check(identity, ONES)
        _check(cov, COV_BP)
    elif method == "fastani":
        # whole 2 kb fragments: 3 of 12 and 9 of 12; identity within the
        # JAX case's gate of the reference binary's values
        _check(identity, [[1.0, 1.0, NAN], [1.0, 0.99997, 0.999959], [NAN, 0.999959, 0.999959]],
               atol=5e-5)  # fmt: skip
        _check(cov, [[1.0, 1.0, NAN], [0.25, 1.0, 0.75], [NAN, 1.0, 1.0]])
    elif method == "sourmash":
        # coverage is k-mer containment, not bp
        _check(identity, ONES)
        _null_crosses(cov)
        assert cov[0, 0] == cov[0, 1] == cov[1, 1] == cov[2, 1] == cov[2, 2] == 1.0
        assert 0 < cov[1, 0] < 1 and 0 < cov[1, 2] < 1
    else:
        _null_crosses(identity)
        _null_crosses(cov)
        assert (identity[~np.isnan(identity)] > 0.95).all(), identity
        # "both" holds each single contig: it covers the contig as the
        # contig covers itself
        assert cov[0, 1] == cov[0, 0] and cov[2, 1] == cov[2, 2], cov


@pytest.mark.parametrize("method", ["anim", "dnadiff", "anib"])
def test_divergent_contigs(method: str, inputs, jax_runs, tmp_path: Path) -> None:
    """The divergent two-contig pair: both directions a number below 1,
    self rows exactly 1, as in the JAX package."""
    identity = _port_equals_jax(inputs, jax_runs, tmp_path, "contigs", method).identity
    assert identity[0, 0] == identity[1, 1] == 1.0
    assert 0.9 < identity[0, 1] < 1 and 0.9 < identity[1, 0] < 1


@pytest.mark.parametrize("method", ["anim", "dnadiff", "anib"])
def test_batched_plain_paths(method: str, inputs, jax_runs, tmp_path: Path, monkeypatch) -> None:
    """The port's batched plain paths (the PyTorch versions of the card's
    kernels) over the coverage set and the divergent pair give the JAX
    package's rows; the plain version of the method's kernel ran."""
    for name in ("coverage", "contigs"):  # the JAX package on its own paths
        jax_runs(name, method)
    monkeypatch.setenv("PYANI_TPU_EXTEND_BATCH_MIN", "1")
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "1")
    tasks = []
    module, name = (sw, "batch_sw_best_reference") if method == "anib" else (extend, "batch_extend_reference")
    real = getattr(module, name)

    def spy(batch, *args, **kwargs):
        tasks.append(len(batch))
        return real(batch, *args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    saved = torch.get_num_threads()
    torch.set_num_threads(1)  # beside other test processes more threads only contend
    try:
        port = _port_equals_jax(inputs, jax_runs, tmp_path, "coverage", method)
        _check(port.coverage, COV_BP)
        _port_equals_jax(inputs, jax_runs, tmp_path, "contigs", method)
    finally:
        torch.set_num_threads(saved)
    assert sum(tasks) > 0


def test_multicontig_per_sequence_filtering(tmp_path: Path) -> None:
    """delta-filter's chains run per sequence, not across contigs: the
    query's second contig aligns inside the span of the subject's first
    contig on a joint axis, and both blocks must survive. Every
    ``align_sequences`` call and both ``compute_pair``s equal the JAX
    package's."""
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    s1, s2 = bases[rng.integers(0, 4, 3000)], bases[rng.integers(0, 4, 4000)]
    write_multi_fasta(tmp_path / "subject.fasta", [("S1", s1), ("S2", s2)])
    # Q1 covers all of S1; Q2 is S2[500:1500]
    write_multi_fasta(tmp_path / "query.fasta", [("Q1", s1), ("Q2", s2[500:1500])])
    subject, query = (load_genome(tmp_path / f"{name}.fasta") for name in ("subject", "query"))
    jax_subject, jax_query = (jax_load_genome(tmp_path / f"{name}.fasta") for name in ("subject", "query"))
    for s_rec, jax_s in zip(subject.records, jax_subject.records):
        for q_rec, jax_q in zip(query.records, jax_query.records):
            for mode in ("mum", "maxmatch"):
                got = anim.align_sequences(s_rec.codes, q_rec.codes, mode=mode)
                want = jax_anim.align_sequences(jax_s.codes, jax_q.codes, mode=mode)
                assert [dataclasses.astuple(b) for b in got] == [dataclasses.astuple(b) for b in want]
    result = anim.compute_pair(query, subject)
    assert result == jax_anim.compute_pair(jax_query, jax_subject)
    # both blocks survive: every query base aligns, without an error
    assert result["identity"] == 1.0
    assert result["aln_length"] == 4000
    assert result["cov_query"] == 1.0
    assert result["sim_errors"] == 0
    dd = dnadiff.compute_pair(query, subject)
    assert dd == jax_dnadiff.compute_pair(jax_query, jax_subject)
    assert dd["identity"] == 1.0
    assert dd["aln_length"] == 4000
