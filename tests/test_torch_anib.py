"""The port's ANIb against the JAX package, all-vs-all on small genomes.

With ``PYANI_TPU_ANIB_DEVICE=1`` the port scores every candidate through
``batch_sw_best`` (on a CPU-only host: the plain PyTorch version). The
JAX package runs its CPU production path (``=0``, the native host
scorer) and its device path (``=1``, the ``dp_jax`` scan on XLA's CPU
backend). Rows must be equal: integers exact, floats equal. Genomes are
synthetic (one ancestor, substitutions with indels, N runs and IUPAC
letters) from a numpy seed.

The counterpart of ``tests/test_anib.py`` too, case for case, on
synthetic genomes in place of the viral fixtures (blastn's per-fragment
rows and the reference's spot values stay with the fixtures):
``test_fragment_counts_and_tail`` on a random genome of the fixture's
39,253 bp, ``test_per_fragment_blast_parity`` as each fragment's best
alignment equal between the packages, and
``test_group_pooled_scoring_matches_per_pair`` on the host scorer. Held
by the cases above: ``test_pair_summary_matches_doctest_values`` and
``test_device_batched_scores_match_host`` by
``test_compute_pair_matches_jax_host_path`` (the port's pair on both
routes equal to the JAX host path's), ``test_device_pipeline_matches_host_path``
by ``test_compute_matches_jax[2]`` (two groups a column through the
lookahead pipeline, rows equal to the JAX host rows). Held by
``tests/test_torch_sw.py::test_reference_matches_pallas_dp_jax_and_native[pallas]``
on the same seeded tasks: ``test_pallas_sw_scores_match_host``.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import pytest
import torch

import pyani_plus_tpu.methods.anib as jax_anib
from pyani_plus_tpu.genomes import load_genome
from pyani_plus_tpu.ops.dp import local_align_stats
from pyani_plus_tpu.ops.seeds import SeedIndex
from pyani_plus_tpu_torch import backend, methods, native
from pyani_plus_tpu_torch.methods import anib
from pyani_plus_tpu_torch.ops import _build
from pyani_plus_tpu_torch.ops.seeds import SeedIndex as PortSeedIndex
from pyani_plus_tpu_torch.synthetic import (
    FRAGMENT_GENOME_LENGTH,
    random_sequence,
    write_fasta,
    write_genome_dir,
)

RATES = [0.02, 0.08, 0.15]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory) -> list:
    directory = tmp_path_factory.mktemp("anib_genomes")
    return [load_genome(p) for p in write_genome_dir(directory, 12_000, RATES, seed=11)]


def _context(genomes: list) -> methods.ComputeContext:
    run = {g.md5: g for g in genomes}
    return methods.ComputeContext(
        logger=logging.getLogger(__name__),
        genomes=run,
        query_hashes=list(run),
        subject_hashes=list(run),
        pending={(q, s) for q in run for s in run},
        config={"fragsize": 1020},
    )


def _rows(module, genomes: list) -> list[tuple]:
    rows = module.compute(_context(genomes))
    return sorted(
        (r["query_hash"], r["subject_hash"], r["identity"], r["aln_length"],
         r["sim_errors"], r["cov_query"], r["cov_subject"])
        for r in rows
    )  # fmt: skip


@pytest.fixture(scope="module")
def jax_rows(genomes) -> dict[str, list[tuple]]:
    """The JAX package's rows on its host scorer and on its dp_jax path
    (device batches of 64 tasks, so that the padding stays small)."""
    out = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_anib, "DEVICE_BATCH", 64)
        for flag in ("0", "1"):
            patch.setenv("PYANI_TPU_ANIB_DEVICE", flag)
            out[flag] = _rows(jax_anib, genomes)
    return out


@pytest.mark.parametrize("group", [1, 2])
def test_compute_matches_jax(genomes, jax_rows, monkeypatch, group) -> None:
    """Group sizes 1 and 2 (3 queries per subject): the lookahead
    pipeline drains across groups, and the last group is short."""
    launched: list[int] = []
    real = anib.batch_sw_best_submit

    def spy(tasks, devices):
        launched.append(len(tasks))
        return real(tasks, devices)

    monkeypatch.setattr(anib, "batch_sw_best_submit", spy)
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "1")
    monkeypatch.setenv("PYANI_TPU_ANIB_GROUP", str(group))
    got = _rows(anib, genomes)
    assert len(launched) == 3 * -(-3 // group)  # one batch per group
    assert got == jax_rows["0"]
    assert got == jax_rows["1"]
    identity = {(q, s): ident for q, s, ident, *_ in got}
    g = [x.md5 for x in genomes]
    assert identity[(g[0], g[0])] == 1.0
    assert identity[(g[0], g[1])] > identity[(g[0], g[2])] > 0.75


def test_compute_pair_matches_jax_host_path(genomes, monkeypatch) -> None:
    query, subject = genomes[2], genomes[0]
    indexes = [SeedIndex(rec.codes) for rec in subject.records]
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "0")
    expected = jax_anib.compute_pair(query, subject, indexes, 1020)
    assert anib.compute_pair(query, subject, indexes, 1020) == expected
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "1")
    assert anib.compute_pair(query, subject, indexes, 1020) == expected


def test_score_device_takes_windows_past_the_jax_limit() -> None:
    """A window over MAX_DEVICE_WINDOW (which the JAX package scores on
    the host, without a trim) goes through the port's scorer, and its
    trim gives the full-window stats."""
    rng = np.random.default_rng(3)
    frag = rng.integers(0, 4, 300).astype(np.uint8)
    window = rng.integers(0, 4, jax_anib.MAX_DEVICE_WINDOW + 700).astype(np.uint8)
    at = jax_anib.MAX_DEVICE_WINDOW + 100
    window[at : at + frag.size] = frag
    pairs = [(frag, window), (frag[:50], window[:400])]
    scores, trims = anib._score_device(pairs)
    assert scores == jax_anib._score_host(pairs)
    full = local_align_stats(frag, window)
    assert trims[0] == (full.query_end, full.subject_end)
    assert trims[0][1] > jax_anib.MAX_DEVICE_WINDOW
    trimmed = local_align_stats(frag[: trims[0][0]], window[: trims[0][1]])
    assert trimmed == full


def test_compute_loads_native_libraries_before_the_pools(
    genomes, monkeypatch, tmp_path
) -> None:
    """On a fresh checkout the native libraries build at first use. A
    slow build must not send the scoring and winner-stats pools to the
    numpy routes: the loader holds its lock across build and load, so
    every pool thread that asks meanwhile waits for libalign and
    libseedjoin."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    real_compile = _build._compile_host
    built: list[str] = []

    def slow_compile(src, so):
        time.sleep(0.5)
        built.append(src.name)
        return real_compile(src, so)

    monkeypatch.setattr(_build, "_compile_host", slow_compile)
    loaded: list[object] = []
    for lib in ("align", "seedjoin"):
        real_load = getattr(native, f"_load_{lib}")

        def spy(real_load=real_load):
            result = real_load()
            loaded.append(result)
            return result

        monkeypatch.setattr(native, f"_load_{lib}", spy)
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "0")
    monkeypatch.setenv("PYANI_TPU_INTRA_WORKERS", "4")
    rows = anib.compute(_context(genomes[:2]))
    assert len(rows) == 4
    assert loaded and None not in loaded
    assert sorted(built) == ["align.cpp", "seedjoin.cpp"]


def test_use_device_follows_env_and_backend(monkeypatch) -> None:
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "1")
    assert anib.use_device()
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "0")
    assert not anib.use_device()
    monkeypatch.delenv("PYANI_TPU_ANIB_DEVICE")
    assert anib.use_device() is backend.on_card()
    monkeypatch.setenv(backend.ENV_DEVICE, "cpu")
    assert not anib.use_device()


def test_registry_and_configuration() -> None:
    assert methods.get_method("ANIb") is anib
    assert anib.configuration() == jax_anib.configuration()
    assert anib.configuration(fragsize=500) == jax_anib.configuration(fragsize=500)
    assert (anib.NAME, anib.PROGRAM, anib.FRAGSIZE) == (
        jax_anib.NAME, jax_anib.PROGRAM, jax_anib.FRAGSIZE
    )  # fmt: skip


def test_fragment_counts_and_tail(tmp_path) -> None:
    """The tail fragment is kept: ceil(39,253 / 1,020) = 39 fragments."""
    seq = random_sequence(FRAGMENT_GENOME_LENGTH, np.random.default_rng(39))
    genome = load_genome(write_fasta(tmp_path / "g.fna", "g", seq))
    frags = anib.fragment_genome(genome, 1020)
    expected = jax_anib.fragment_genome(genome, 1020)
    assert len(frags) == len(expected) == 39
    assert all(np.array_equal(a, b) for a, b in zip(frags, expected))
    assert frags[-1].size == FRAGMENT_GENOME_LENGTH - 38 * 1020


def test_per_fragment_blast_parity(genomes) -> None:
    """Every fragment's best alignment (the blastn HSP's statistics) is
    the JAX package's, field for field."""
    query, subject = genomes[1], genomes[0]
    codes = [rec.codes for rec in subject.records]
    port_indexes = [PortSeedIndex(c) for c in codes]
    jax_indexes = [SeedIndex(c) for c in codes]
    found = 0
    for i, frag in enumerate(anib.fragment_genome(query, 1020)):
        got = anib.best_fragment_alignment(frag, codes, port_indexes)
        want = jax_anib.best_fragment_alignment(frag, codes, jax_indexes)
        assert (got is None) == (want is None), i
        if got is not None:
            assert dataclasses.astuple(got) == dataclasses.astuple(want), i
            found += 1
    assert found > 5


def test_group_pooled_scoring_matches_per_pair(genomes, jax_rows, monkeypatch) -> None:
    """Scoring tasks of three queries pooled, on the host scorer: the
    unpooled rows, which are the JAX package's."""
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "0")
    rows = {}
    for group in ("3", "1"):
        monkeypatch.setenv("PYANI_TPU_ANIB_GROUP", group)
        rows[group] = _rows(anib, genomes)
    assert rows["3"] == rows["1"] == jax_rows["0"]
