"""The port's method and runner contracts against the JAX package's.

The counterpart of ``tests/test_runner_contracts.py``, case for case:
the registry, the method interface, ``run_pairwise``'s order, pool and
interrupt handling, the flush window and the FASTA index. Each case runs
the same input through both packages' functions and compares what they
give, and the port must also meet the JAX test's own assertions.
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path

import pytest

import pyani_plus_tpu.methods as jax_methods
import pyani_plus_tpu.utils as jax_utils
import pyani_plus_tpu_torch.methods as torch_methods
import pyani_plus_tpu_torch.utils as torch_utils
from pyani_plus_tpu.parallel.runner import index_fasta_directory as jax_index
from pyani_plus_tpu_torch.parallel.runner import index_fasta_directory as torch_index
from pyani_plus_tpu_torch.synthetic import write_alignment

LOGGER = logging.getLogger("test")
PACKAGES = {"jax": jax_methods, "torch": torch_methods}
PAIR_FOUR = [("a", "a"), ("a", "b"), ("b", "a"), ("b", "b")]


def _ctx(package, pending, **kwargs):
    return package.ComputeContext(
        logger=LOGGER,
        genomes={},
        query_hashes=[],
        subject_hashes=[],
        pending=set(pending),
        config={},
        **kwargs,
    )


def test_registry_names_match_reference_spelling() -> None:
    """Method names are the reference's exact matrix/configuration names,
    in the JAX package's order."""
    assert torch_methods.method_names() == jax_methods.method_names()
    assert set(torch_methods.method_names()) == {
        "sourmash",
        "fastANI",
        "ANIm",
        "ANIb",
        "ANIminimap2",
        "dnadiff",
        "skani",
        "external-alignment",
    }


def test_get_method_unknown_raises() -> None:
    """An unknown name gets the JAX package's message, letter for letter."""
    messages = {}
    for tag, package in PACKAGES.items():
        with pytest.raises(ValueError, match=r"^Unknown method 'nope'; known: ") as err:
            package.get_method("nope")
        messages[tag] = str(err.value)
    assert messages["torch"] == messages["jax"]


@pytest.fixture(scope="module")
def alignment(tmp_path_factory) -> Path:
    _paths, path = write_alignment(tmp_path_factory.mktemp("aln"), 600, [0.02, 0.05], seed=3)
    return path


@pytest.mark.parametrize("name", torch_methods.method_names())
def test_every_method_module_interface(name, alignment) -> None:
    """NAME / configuration() / compute(ctx) on every module, with the
    configuration recording method+program+version, equal to the JAX
    module's (external-alignment's over a synthetic alignment file)."""
    module = torch_methods.get_method(name)
    assert module.NAME == name
    assert callable(module.compute)
    assert module.__name__.startswith("pyani_plus_tpu_torch.methods.")
    params = {"alignment": alignment} if name == "external-alignment" else {}
    config = module.configuration(**params)
    assert config == jax_methods.get_method(name).configuration(**params)
    assert config["method"] == name
    # the JAX package's program names, so that each package resumes the other's runs
    assert config["program"].startswith("pyani-plus-tpu")
    assert config["version"]


def test_run_pairwise_sequential_order_and_progress(monkeypatch) -> None:
    monkeypatch.setenv("PYANI_TPU_PAIR_WORKERS", "1")  # pin the serial path
    got = {}
    for tag, package in PACKAGES.items():
        seen, ticks = [], []
        ctx = _ctx(package, PAIR_FOUR, progress=ticks.append)
        rows = package.run_pairwise(ctx, lambda q, s: seen.append((q, s)) or {"identity": 1.0})
        got[tag] = (seen, ticks, rows, ctx.interrupted)
    assert got["torch"] == got["jax"]
    seen, ticks, rows, interrupted = got["torch"]
    assert seen == sorted(PAIR_FOUR)  # deterministic order
    assert len(rows) == 4
    assert sum(ticks) == 4
    assert all(r["query_hash"] == q and r["subject_hash"] == s
               for r, (q, s) in zip(rows, sorted(PAIR_FOUR)))  # fmt: skip
    assert not interrupted


def test_run_pairwise_interrupt_keeps_completed_rows(monkeypatch) -> None:
    """KeyboardInterrupt mid-run returns the completed rows and flags
    the context (the 'Worker interrupted' persistence contract)."""
    monkeypatch.setenv("PYANI_TPU_PAIR_WORKERS", "1")  # pin the serial path
    got = {}
    for tag, package in PACKAGES.items():
        calls = []

        def fn(q, s, calls=calls):
            if len(calls) == 2:
                raise KeyboardInterrupt
            calls.append((q, s))
            return {"identity": 0.5}

        ctx = _ctx(package, PAIR_FOUR)
        got[tag] = (package.run_pairwise(ctx, fn), ctx.interrupted)
    assert got["torch"] == got["jax"]
    rows, interrupted = got["torch"]
    assert interrupted
    assert len(rows) == 2


def test_run_pairwise_default_pool_is_available_cores(monkeypatch) -> None:
    """Host pair-parallelism defaults ON, sized to the host's cores (the
    reference's local executor runs `--cores all`); =1 opts back out."""
    monkeypatch.delenv("PYANI_TPU_PAIR_WORKERS", raising=False)
    for utils in (jax_utils, torch_utils):
        monkeypatch.setattr(utils, "available_cores", lambda: 3)
    pairs = [(f"g{i}", f"g{j}") for i in range(3) for j in range(3)]
    for package in PACKAGES.values():
        threads = set()

        def fn(q, s, threads=threads):
            threads.add(threading.current_thread().name)
            return {"identity": 0.25}

        rows = package.run_pairwise(_ctx(package, pairs), fn)
        assert {(r["query_hash"], r["subject_hash"]) for r in rows} == set(pairs)
        # the pool path ran (worker threads, not the calling thread only)
        assert any("ThreadPoolExecutor" in name for name in threads), package.__name__


def test_run_pairwise_thread_pool_matches_sequential(monkeypatch) -> None:
    monkeypatch.setenv("PYANI_TPU_PAIR_WORKERS", "3")
    pairs = [(f"g{i}", f"g{j}") for i in range(4) for j in range(4)]
    expected = {(q, s): hash((q, s)) % 100 / 100 for q, s in pairs}
    got = {}
    for tag, package in PACKAGES.items():
        rows = package.run_pairwise(_ctx(package, pairs), lambda q, s: {"identity": expected[q, s]})
        got[tag] = {(r["query_hash"], r["subject_hash"]): r["identity"] for r in rows}
        assert len(rows) == len(pairs)
    assert got["torch"] == got["jax"] == expected


def test_maybe_flush_respects_window(monkeypatch) -> None:
    """No flush before the window elapses; flush once it has. The window
    is the JAX package's."""
    assert torch_methods.FLUSH_WINDOW == jax_methods.FLUSH_WINDOW
    for package in PACKAGES.values():
        flushed = []
        ctx = _ctx(package, [], flush=flushed.append)
        monkeypatch.setattr(package, "FLUSH_WINDOW", 3600.0)
        ctx.maybe_flush([{"x": 1}])  # first call only arms the timer
        ctx.maybe_flush([{"x": 1}, {"x": 2}])
        assert flushed == [], package.__name__
        monkeypatch.setattr(package, "FLUSH_WINDOW", 0.0)
        rows = [{"x": 1}, {"x": 2}, {"x": 3}]
        ctx.maybe_flush(rows)
        assert flushed == [rows], package.__name__


def test_maybe_flush_without_sink_is_noop() -> None:
    for package in PACKAGES.values():
        _ctx(package, []).maybe_flush([{"x": 1}])  # must not raise


def test_index_fasta_directory_maps_md5(tmp_path) -> None:
    (tmp_path / "a.fasta").write_text(">a\nACGTACGT\n")
    (tmp_path / "b.fna").write_text(">b\nTTTTCCCC\n")
    (tmp_path / "notes.txt").write_text("not a genome")
    mapping = torch_index(LOGGER, tmp_path)
    assert mapping == jax_index(LOGGER, tmp_path)
    assert {p.name for p in mapping.values()} == {"a.fasta", "b.fna"}
    for md5, path in mapping.items():
        assert md5 == torch_utils.file_md5sum(path)
