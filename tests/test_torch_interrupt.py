"""SIGINT to a live run of the port's CLI, then ``resume``.

The counterpart of ``tests/test_interrupt.py``: the port's CLI runs in a
subprocess over eight synthetic genomes (64 ordered pairs). Once the
store says ``Running``, the test waits ``DELAY`` seconds and sends
SIGINT. The run must exit within 60 s with code 0, the JAX CLI's code for
an interrupt (its runner marks the run and returns), with no traceback,
the status ``Worker interrupted`` and some but not all of the rows
stored. ``resume`` then completes it: ``Done``, every pair stored, and on
a fixed subset of the pairs the rows equal those that the JAX package's
method computes in-process for the same genomes.

Unlike the JAX test, this one has no skip for a run that ends before the
signal. The port's host libraries are built before the CLI starts, so
that no build falls between ``Running`` and the signal. The pairs run one
at a time (``PYANI_TPU_PAIR_WORKERS=1``; a pair's own pools still use
every core), so that the first rows land within a fraction of ``DELAY``,
and the genomes are sized so that an uninterrupted run lasts more than
ten times ``DELAY`` from ``Running`` to its end on an idle 8-core host
(ANIm on 70 kb genomes about 25 s, fastANI on 1.5 Mb genomes about 28 s);
several test processes side by side only make it longer.
"""

from __future__ import annotations

import logging
import os
import signal
import sqlite3
import subprocess
import sys
import time
from pathlib import Path

import pytest

import pyani_plus_tpu.methods as jax_methods
from pyani_plus_tpu.genomes import load_genome
from pyani_plus_tpu_torch.ops._build import NATIVE_DIR, load_host_library
from pyani_plus_tpu_torch.synthetic import write_genome_dir
from pyani_plus_tpu_torch.utils import file_md5sum

REPO = Path(__file__).resolve().parents[1]
DELAY = 2.0  # seconds between the store's "Running" and the signal
N_GENOMES = 8
COLUMNS = "identity, aln_length, sim_errors, cov_query, cov_subject"


def _status(db: Path) -> str | None:
    if not db.is_file():
        return None
    try:
        with sqlite3.connect(db) as conn:
            row = conn.execute("SELECT status FROM runs").fetchone()
    except sqlite3.OperationalError:  # the store is being created
        return None
    return row[0] if row else None


def _rows(db: Path) -> dict[tuple[str, str], tuple]:
    with sqlite3.connect(db) as conn:
        return {
            (q, s): tuple(rest)
            for q, s, *rest in conn.execute(
                f"SELECT query_hash, subject_hash, {COLUMNS} FROM comparisons"  # noqa: S608
            )
        }


@pytest.fixture(scope="module", autouse=True)
def _host_libraries() -> None:
    """Every host library of the port, built (or found) before a CLI starts."""
    for source in sorted(NATIVE_DIR.glob("*.cpp")):
        load_host_library(source.stem)


def _cli(*args: str) -> list[str]:
    return [sys.executable, "-m", "pyani_plus_tpu_torch.cli.main", *args]


def _jax_rows(method: str, paths: list[Path], pairs: set[tuple[str, str]]) -> dict:
    """The JAX package's rows for ``pairs`` of these genomes, in-process."""
    module = jax_methods.get_method(method)
    genomes = {file_md5sum(path): path for path in paths}
    ctx = jax_methods.ComputeContext(
        logger=logging.getLogger("test"),
        genomes={md5: load_genome(path, md5) for md5, path in genomes.items()},
        query_hashes=sorted(genomes),
        subject_hashes=sorted(genomes),
        pending=set(pairs),
        config=module.configuration(),
    )
    return {
        (row["query_hash"], row["subject_hash"]): tuple(
            row[key] for key in COLUMNS.split(", ")
        )
        for row in module.compute(ctx)
    }


@pytest.mark.parametrize(
    ("command", "method", "length"),
    [("anim", "ANIm", 70_000), ("fastani", "fastANI", 1_500_000)],
)
def test_sigint_mid_run(command: str, method: str, length: int, tmp_path: Path) -> None:
    """SIGINT mid-run, partial rows kept, ``resume`` to rows equal to the
    JAX package's, for an alignment method and a sketch method."""
    paths = write_genome_dir(
        tmp_path / "genomes", length, [0.01 + 0.005 * i for i in range(N_GENOMES)], seed=42
    )
    db = tmp_path / "db.sqlite"
    env = {**os.environ, "PYANI_TPU_PAIR_WORKERS": "1"}
    proc = subprocess.Popen(
        _cli(command, str(tmp_path / "genomes"), "-d", str(db), "--create-db"),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )  # fmt: skip
    try:
        deadline = time.monotonic() + 120
        while _status(db) != "Running" and proc.poll() is None:
            assert time.monotonic() < deadline, "the run never reached Running"
            time.sleep(0.05)
        time.sleep(DELAY)
        assert proc.poll() is None, "the run ended before the signal: make it longer"
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = out.decode()
    assert proc.returncode == 0, text[-2000:]
    assert "Traceback" not in text, text[-2000:]
    assert _status(db) == "Worker interrupted", text[-2000:]
    n_pairs = N_GENOMES**2
    partial = _rows(db)
    assert 1 <= len(partial) < n_pairs, len(partial)

    result = subprocess.run(
        _cli("resume", "-d", str(db)), cwd=REPO, env=env, capture_output=True, timeout=600,
        check=False,
    )  # fmt: skip
    assert result.returncode == 0, result.stderr.decode()[-2000:]
    assert _status(db) == "Done"
    rows = _rows(db)
    assert len(rows) == n_pairs
    assert {pair: rows[pair] for pair in partial} == partial  # resume kept them

    # a fixed subset: self pairs and both directions of cross pairs
    hashes = [file_md5sum(path) for path in paths]
    subset = {
        (hashes[q], hashes[s])
        for q in range(N_GENOMES)
        for s in range(N_GENOMES)
        if (q + s) % N_GENOMES == 0
    }
    assert {pair: rows[pair] for pair in subset} == _jax_rows(method, paths, subset)


def test_sigterm_mid_run_both_packages(tmp_path: Path) -> None:
    """SIGTERM, as SLURM sends it, to a live ANIm run of each package's
    CLI, side by side: the same exit code (the JAX runner turns SIGTERM
    into its interrupt), ``Worker interrupted`` with partial rows, and
    after ``resume`` every row equal between the packages."""
    write_genome_dir(
        tmp_path / "genomes", 50_000, [0.01 + 0.005 * i for i in range(N_GENOMES)], seed=43
    )
    env = {**os.environ, "PYANI_TPU_PAIR_WORKERS": "1"}
    clis = {"jax": "pyani_plus_tpu.cli.main", "torch": "pyani_plus_tpu_torch.cli.main"}
    dbs = {tag: tmp_path / f"{tag}.sqlite" for tag in clis}
    procs = {
        tag: subprocess.Popen(
            [sys.executable, "-m", module, "anim", str(tmp_path / "genomes"), "-d", str(dbs[tag]),
             "--create-db"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for tag, module in clis.items()
    }  # fmt: skip
    outcomes = {}
    try:
        signalled: set[str] = set()
        deadline = time.monotonic() + 120
        running: dict[str, float] = {}
        while len(signalled) < len(procs):
            assert time.monotonic() < deadline, "a run never reached Running"
            for tag, proc in procs.items():
                if tag not in running and _status(dbs[tag]) == "Running":
                    running[tag] = time.monotonic()
                if tag in running and tag not in signalled and time.monotonic() > running[tag] + DELAY:
                    assert proc.poll() is None, f"{tag}: the run ended before the signal"
                    proc.send_signal(signal.SIGTERM)
                    signalled.add(tag)
                assert tag in signalled or proc.poll() is None, f"{tag} ended early"
            time.sleep(0.05)
        for tag, proc in procs.items():
            out, _ = proc.communicate(timeout=60)
            outcomes[tag] = (proc.returncode, out.decode())
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert outcomes["torch"][0] == outcomes["jax"][0] == 0, outcomes["torch"][1][-2000:]
    for tag, (_code, text) in outcomes.items():
        assert "Traceback" not in text, text[-2000:]
        assert _status(dbs[tag]) == "Worker interrupted", (tag, text[-2000:])
        assert 1 <= len(_rows(dbs[tag])) < N_GENOMES**2, tag

    resumes = {
        tag: subprocess.Popen([sys.executable, "-m", module, "resume", "-d", str(dbs[tag])], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for tag, module in clis.items()
    }  # fmt: skip
    for tag, proc in resumes.items():
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, (tag, out.decode()[-2000:])
        assert _status(dbs[tag]) == "Done"
    rows = {tag: _rows(db) for tag, db in dbs.items()}
    assert len(rows["torch"]) == N_GENOMES**2
    assert rows["torch"] == rows["jax"]
