"""The port's ANIm and dnadiff against the JAX package, pair by pair.

With ``PYANI_TPU_EXTEND_BATCH_MIN=1`` every full-band extension of the
port goes through ``batch_extend`` (on a CPU-only host: the plain
PyTorch version); the JAX package runs its CPU production path, the
native host kernel. The comparison dicts must be equal: integers exact,
floats equal. Genomes are synthetic (one ancestor, substitutions with
indels, N runs and IUPAC letters) from a numpy seed.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import pytest
import torch

import pyani_plus_tpu.methods.anim as jax_anim
import pyani_plus_tpu.methods.dnadiff as jax_dnadiff
from pyani_plus_tpu.genomes import load_genome
from pyani_plus_tpu_torch import backend, methods
from pyani_plus_tpu_torch.methods import anim, dnadiff
from pyani_plus_tpu_torch.ops import _build, suffix
from pyani_plus_tpu_torch.synthetic import write_genome_dir

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
    expected = anim.EXT_BATCH_MIN_CUDA if backend.probe().cuda else anim.EXT_BATCH_MIN
    assert anim._default_ext_batch_min() == expected
    assert backend.kernel_device().type == ("cuda" if backend.probe().cuda else "cpu")


def test_registry_and_configuration() -> None:
    assert methods.method_names() == ["ANIm", "dnadiff", "ANIb", "sourmash"]
    assert methods.get_method("ANIm") is anim
    assert methods.get_method("dnadiff") is dnadiff
    with pytest.raises(ValueError, match="not ported.*ANIm"):
        methods.get_method("fastANI")
    assert anim.configuration() == jax_anim.configuration()
    assert anim.configuration(mode="maxmatch") == jax_anim.configuration(mode="maxmatch")
    assert dnadiff.configuration() == jax_dnadiff.configuration()
