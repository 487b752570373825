"""The port's ANIm and dnadiff against the JAX package, pair by pair.

With ``PYANI_TPU_EXTEND_BATCH_MIN=1`` every full-band extension of the
port goes through ``batch_extend`` (on a CPU-only host: the plain
PyTorch version); the JAX package runs its CPU production path, the
native host kernel. The comparison dicts must be equal: integers exact,
floats equal. Genomes are synthetic (one ancestor, substitutions with
indels, N runs and IUPAC letters) from a numpy seed.

The counterpart of ``tests/test_anim.py`` too, case for case:
``test_mum_finding_basic`` and ``test_n_never_matches_in_mums`` through
both packages' ``maximal_matches``; ``test_spot_value_rotated_pair`` and
``test_filtered_alignment_blocks`` on a synthetic rotated pair
(``synthetic.write_rotated_pair``) in place of the viral fixtures' (the
reference's spot values and nucmer's block coordinates stay with the
fixtures), the port's row and blocks equal to the JAX package's. Held
elsewhere on synthetic genomes: ``test_matrices_vs_fixtures`` by
``tests/test_torch_cli.py::test_cli_export_matches_jax[anim]`` (all nine
cells of both CLIs' exports equal), ``test_self_vs_self_n_run_anomaly``
by ``tests/test_torch_self_vs_self.py::test_self_vs_self_anim_n_run``,
``test_bad_alignments_all_null`` by
``tests/test_torch_bad_alignments_e2e.py``, and
``test_multicontig_per_sequence_filtering`` by
``tests/test_torch_coverage_semantics.py::test_multicontig_per_sequence_filtering``.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import pytest
import torch

import pyani_plus_tpu.methods.anim as jax_anim
import pyani_plus_tpu.methods.dnadiff as jax_dnadiff
import pyani_plus_tpu.ops.chaining as jax_chaining
import pyani_plus_tpu.ops.suffix as jax_suffix
from pyani_plus_tpu.genomes import encode_sequence, load_genome
from pyani_plus_tpu.methods import method_names as jax_method_names
from pyani_plus_tpu_torch import backend, methods
from pyani_plus_tpu_torch.methods import anim, dnadiff
from pyani_plus_tpu_torch.ops import _build, chaining, suffix
from pyani_plus_tpu_torch.synthetic import write_genome_dir, write_rotated_pair

RATES = [0.02, 0.08, 0.15]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory) -> dict[int, list]:
    """Genome length -> genomes at RATES (60 kb and 150 kb sets)."""
    out = {}
    for length in (60_000, 150_000):
        directory = tmp_path_factory.mktemp(f"genomes_{length}")
        paths = write_genome_dir(directory, length, RATES, seed=5)
        out[length] = [load_genome(p) for p in paths]
    return out


@pytest.fixture
def batched(monkeypatch) -> list[int]:
    """Force the batched extension path; record each batch's size."""
    sizes: list[int] = []
    real = anim.batch_extend_submit

    def spy(tasks, device, **kwargs):
        sizes.append(len(tasks))
        return real(tasks, device, **kwargs)

    monkeypatch.setattr(anim, "batch_extend_submit", spy)
    monkeypatch.setenv("PYANI_TPU_EXTEND_BATCH_MIN", "1")
    return sizes


def _jax_row(module, *args, monkeypatch) -> dict:
    with monkeypatch.context() as patch:
        patch.delenv("PYANI_TPU_EXTEND_BATCH_MIN", raising=False)
        return module.compute_pair(*args)


# (length, query, subject): the slow 180-task 2%/8% pair is left to the
# card; these pairs keep the plain version's row loop to a few seconds
ANIM_PAIRS = [(60_000, 2, 1), (60_000, 0, 2), (150_000, 1, 2)]


@pytest.mark.parametrize(("length", "q", "s"), ANIM_PAIRS)
def test_anim_pair_matches_jax(genomes, batched, monkeypatch, length, q, s) -> None:
    query, subject = genomes[length][q], genomes[length][s]
    got = anim.compute_pair(query, subject)
    assert batched and sum(batched) > 0  # the batched path ran
    expected = _jax_row(jax_anim, query, subject, monkeypatch=monkeypatch)
    assert got == expected
    assert 0.7 < got["identity"] < 1.0


def test_dnadiff_pair_matches_jax(genomes, batched, monkeypatch) -> None:
    query, subject = genomes[60_000][1], genomes[60_000][2]
    got = dnadiff.compute_pair(query, subject)
    assert batched and sum(batched) > 0
    expected = _jax_row(jax_dnadiff, query, subject, monkeypatch=monkeypatch)
    assert got == expected


@pytest.mark.parametrize("module", [anim, dnadiff], ids=["anim", "dnadiff"])
def test_compute_loads_native_libraries_before_the_pair_pool(
    genomes, monkeypatch, tmp_path, module
) -> None:
    """On a fresh checkout the native libraries build at first use. A
    slow build must not send the pair pool's threads to the numpy
    seeding route: the loader holds its lock across build and load, so
    every thread that asks meanwhile waits for the library."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(suffix, "_NATIVE_SAM_OK", None)
    real_compile = _build._compile_host
    built: list[str] = []

    def slow_compile(src, so):
        time.sleep(0.5)
        built.append(src.name)
        return real_compile(src, so)

    monkeypatch.setattr(_build, "_compile_host", slow_compile)
    numpy_route: list[int] = []
    real_matches = anim.maximal_matches

    def spy(*args, **kwargs):
        numpy_route.append(1)
        return real_matches(*args, **kwargs)

    monkeypatch.setattr(anim, "maximal_matches", spy)
    monkeypatch.setenv("PYANI_TPU_PAIR_WORKERS", "4")
    run = {g.md5: g for g in genomes[60_000][:2]}
    ctx = methods.ComputeContext(
        logger=logging.getLogger(__name__),
        genomes=run,
        query_hashes=list(run),
        subject_hashes=list(run),
        pending={(q, s) for q in run for s in run},
        config={"mode": "mum"},
    )
    rows = module.compute(ctx)
    assert len(rows) == 4
    assert not numpy_route
    assert suffix.seed_index_enabled()
    # each library was built once, into the build directory, by rename
    assert sorted(built) == ["band.cpp", "chain.cpp", "suffix.cpp"]
    assert not list((tmp_path / "build").glob("*.tmp"))
    assert len(list((tmp_path / "build").glob("lib*-host-*.so"))) == 3


def test_run_extensions_matches_jax_host_path(batched, monkeypatch) -> None:
    """Task filtering: empty and short (< EXT_BAND) tasks stay on the host
    kernel with a shrunk band, the rest batch; results land in order."""
    rng = np.random.default_rng(9)
    tasks = [(np.zeros(0, np.uint8), rng.integers(0, 4, 90).astype(np.uint8))]
    for m, n in ((30, 25), (59, 20), (61, 300), (900, 850), (400, 1200)):
        a = rng.integers(0, 4, m).astype(np.uint8)
        b = np.concatenate([a, rng.integers(0, 4, n).astype(np.uint8)])[:n]
        mut = rng.random(b.size) < 0.1
        b[mut] = (b[mut] + 1) % 4
        tasks.append((a, b))
    got = anim._run_extensions(tasks)
    assert batched == [3]
    with monkeypatch.context() as patch:
        patch.delenv("PYANI_TPU_EXTEND_BATCH_MIN")
        assert got == jax_anim._run_extensions(tasks)


def test_default_batch_threshold_follows_backend(monkeypatch) -> None:
    monkeypatch.delenv("PYANI_TPU_EXTEND_BATCH_MIN", raising=False)
    expected = anim.EXT_BATCH_MIN_CUDA if backend.on_card() else anim.EXT_BATCH_MIN
    assert anim._default_ext_batch_min() == expected
    assert backend.kernel_device().type == ("cuda" if backend.on_card() else "cpu")
    monkeypatch.setenv(backend.ENV_DEVICE, "cpu")
    assert anim._default_ext_batch_min() == anim.EXT_BATCH_MIN


def test_registry_and_configuration() -> None:
    assert methods.method_names() == jax_method_names()
    assert methods.get_method("ANIm") is anim
    assert methods.get_method("dnadiff") is dnadiff
    with pytest.raises(ValueError, match=r"^Unknown method 'no-such-method'; known: .*'ANIm'"):
        methods.get_method("no-such-method")
    assert anim.configuration() == jax_anim.configuration()
    assert anim.configuration(mode="maxmatch") == jax_anim.configuration(mode="maxmatch")
    assert dnadiff.configuration() == jax_dnadiff.configuration()


def _mums(ref: np.ndarray, qry: np.ndarray) -> list[list[int]]:
    got = [x.tolist() for x in suffix.maximal_matches(ref, qry, min_len=10)]
    assert got == [x.tolist() for x in jax_suffix.maximal_matches(ref, qry, min_len=10)]
    return got


def test_mum_finding_basic() -> None:
    ref = encode_sequence(b"TTTTACGGATCCGATTACAGGTTTT")
    qry = encode_sequence(b"CCCCACGGATCCGATTACAGGCCCC")
    assert _mums(ref, qry) == [[4], [4], [17]]


def test_n_never_matches_in_mums() -> None:
    seq = encode_sequence(b"ACGGATCCGATTACAGGACGT" + b"N" * 30 + b"GATTACACGGATCCGATTAGG")
    starts, _q, lengths = _mums(seq, seq.copy())
    assert starts  # the self matches split at the N run: none spans it
    for rs, ls in zip(starts, lengths):
        assert (seq[rs : rs + ls] < 4).all()


@pytest.fixture(scope="module")
def rotated(tmp_path_factory) -> list:
    paths = write_rotated_pair(tmp_path_factory.mktemp("rotated"), 30_000, 0.01, seed=21)
    return [load_genome(p) for p in paths]


def test_spot_value_rotated_pair(rotated) -> None:
    query, subject = rotated
    res = anim.compute_pair(query, subject)
    assert res == jax_anim.compute_pair(query, subject)
    assert 0.98 < res["identity"] < 1.0
    assert 0.95 * query.length < res["aln_length"] <= query.length
    assert res["sim_errors"] > 0


def test_filtered_alignment_blocks(rotated) -> None:
    """The rotated pair aligns in two blocks that meet at the rotation
    point, the same in both packages: coordinates and error counts."""
    query, subject = rotated

    def coords(align, one_to_one) -> list[tuple[int, ...]]:
        blocks = one_to_one(align(subject.records[0].codes, query.records[0].codes))
        return sorted((b.ref_start + 1, b.ref_end, b.qry_start + 1, b.qry_end, b.errors) for b in blocks)

    got = coords(anim.align_sequences, chaining.one_to_one)
    assert got == coords(jax_anim.align_sequences, jax_chaining.one_to_one)
    assert len(got) == 2
