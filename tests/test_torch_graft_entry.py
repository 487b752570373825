"""The port's entry points (``graft_entry.py``) against ``__graft_entry__.py``.

The JAX functions run as ``tests/test_parallel.py`` runs them, on the 8
virtual CPU devices that ``tests/conftest.py`` sets up; the port runs on
lists that name the CPU several times. Inputs come from numpy seeds, and
every comparison is exact: floats equal, NaNs in the same places,
integers equal.

- ``entry``: the Gram step equals ``jax.jit`` of the JAX step, and the
  example arguments have the JAX shapes and dtypes; without CUDA it needs
  ``device="cpu"``.
- Each step of the dry run equals its JAX counterpart on the same
  inputs: (a) the containment through the mesh, (b) the merge of partial
  matrices, (c) the alignment scores (``dp_jax`` on a flat mesh), (d) the
  two-host ANIb run through the runner (stored rows and cached matrices).
- The whole dry run at 2, 4 and 8 devices; its closing line at 8 is the
  JAX dry run's.
- Errors: too few devices, no CUDA without ``devices``; ``tiles.pair_mesh``
  restores the production mesh on exit and on an exception.
- On the card (``-m gpu``): the dry run over one card named four times.
"""

from __future__ import annotations

import logging
import os
import sqlite3
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import pyani_plus_tpu.db as jax_db
import pyani_plus_tpu.methods.anib as jax_anib
import pyani_plus_tpu.ops.minhash as jax_minhash
import pyani_plus_tpu.parallel.runner as jax_runner
import pyani_plus_tpu.parallel.tiles as jax_tiles
from pyani_plus_tpu.ops.dp_jax import batch_local_align_scores
from pyani_plus_tpu_torch import backend
from pyani_plus_tpu_torch import db as port_db
from pyani_plus_tpu_torch import graft_entry
from pyani_plus_tpu_torch.ops import sw
from pyani_plus_tpu_torch.parallel import tiles

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import __graft_entry__ as jax_graft  # noqa: E402


def _cpus(k: int) -> list[torch.device]:
    return [torch.device("cpu")] * k


def _mesh(k: int) -> tiles.Mesh:
    return tiles.make_mesh(devices=_cpus(k))


def test_entry_is_the_jax_entry() -> None:
    fn, args = graft_entry.entry(device="cpu")
    jax_fn, jax_args = jax_graft.entry()
    assert [tuple(a.shape) for a in args] == [a.shape for a in jax_args]
    assert [str(a.dtype).removeprefix("torch.") for a in args] == [str(a.dtype) for a in jax_args]
    assert all(a.device.type == "cpu" and not a.any() for a in args)
    rng = np.random.default_rng(9)
    n, block = jax_args[1].shape
    counts = rng.integers(0, 1 << 16, (n, n)).astype(np.float32)
    q_block = (rng.random((n, block)) < 0.3).astype(np.int8)
    s_block = (rng.random((n, block)) < 0.3).astype(np.int8)
    got = fn(torch.from_numpy(counts), torch.from_numpy(q_block), torch.from_numpy(s_block))
    expected = np.asarray(jax.jit(jax_fn)(counts, q_block, s_block))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(got.numpy(), counts + q_block.astype(np.float32) @ s_block.astype(np.float32).T)
    zero = fn(*args)
    np.testing.assert_array_equal(zero.numpy(), np.asarray(jax.jit(jax_fn)(*jax_args)))


def test_entry_without_cuda_needs_the_cpu_named(monkeypatch) -> None:
    monkeypatch.setenv(backend.ENV_DEVICE, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()
    assert graft_entry.entry(device="cpu")[1][0].device.type == "cpu"


def _jax_sketches(n_genomes: int) -> list:
    """The JAX dry run's sketches, drawn as ``__graft_entry__.py`` draws
    them."""
    rng = np.random.default_rng(0)
    pool = rng.choice(np.arange(1, 1 << 20, dtype=np.uint64), 4000, replace=False)
    return [
        jax_minhash.Sketch(md5=f"g{i}", ksize=31, scaled=1000,
                           hashes=np.unique(rng.choice(pool, 600, replace=False)))
        for i in range(n_genomes)
    ]  # fmt: skip


@pytest.mark.parametrize("k", [2, 4, 8])
def test_containment_step_is_the_jax_containment(k: int) -> None:
    n_genomes = 8  # max(8, 2 * lcm) for every grid of 2 to 8 devices
    sketches = graft_entry.dryrun_sketches(np.random.default_rng(0), n_genomes)
    expected_sketches = _jax_sketches(n_genomes)
    for got, expected in zip(sketches, expected_sketches):
        assert got.md5 == expected.md5
        np.testing.assert_array_equal(got.hashes, expected.hashes)
    identity, cov = graft_entry.containment_step(_mesh(k), sketches)
    jax_identity, jax_cov = jax_minhash.containment_ani(
        expected_sketches, use_device=True, mesh=jax_tiles.make_mesh(8)
    )
    assert identity.dtype == jax_identity.dtype and cov.dtype == jax_cov.dtype
    np.testing.assert_array_equal(identity, jax_identity)
    np.testing.assert_array_equal(cov, jax_cov)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_merge_step_is_the_jax_merge(k: int) -> None:
    blocks = graft_entry.partial_matrices(np.random.default_rng(k), k, 8)
    assert np.count_nonzero(blocks, axis=0).max() == 1  # every pair owned once
    got = graft_entry.merge_step(_mesh(k), blocks)
    expected = np.asarray(jax_tiles.merge_partial_matrices(blocks, jax_tiles.make_mesh(k)))
    assert got.dtype == expected.dtype == np.float32
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_alignment_step_is_the_jax_dp_on_a_flat_mesh(k: int) -> None:
    nq, ns = _mesh(k).shape
    batch = int(np.lcm(nq, ns)) * graft_entry.DP_TASKS_PER_LCM
    tasks = graft_entry.alignment_tasks(np.random.default_rng(k), batch)
    got = graft_entry.alignment_step(_mesh(k), tasks)
    flat = jax.sharding.Mesh(jax_tiles.make_mesh(k).devices.reshape(-1), ("pairs",))
    sharding = NamedSharding(flat, P("pairs", None))
    queries = jax.device_put(jnp.asarray(np.stack([q for q, _ in tasks]), jnp.int32), sharding)
    subjects = jax.device_put(jnp.asarray(np.stack([s for _, s in tasks]), jnp.int32), sharding)
    expected = np.asarray(batch_local_align_scores(queries, subjects))
    np.testing.assert_array_equal(got, expected)
    assert got.min() == 2 * graft_entry.DP_ROWS
    assert sw.batch_sw_best(tasks, "cpu") == sw.batch_sw_best_host(tasks)


def _stored(dbfile: Path, db_module) -> tuple[list[tuple], list[pd.DataFrame]]:
    """A run's stored comparison rows and its cached matrices."""
    with sqlite3.connect(dbfile) as conn:
        rows = conn.execute(
            "SELECT query_hash, subject_hash, identity, aln_length, sim_errors, cov_query,"
            " cov_subject FROM comparisons ORDER BY query_hash, subject_hash"
        ).fetchall()
    with db_module.Database(dbfile) as db:
        (run,) = [db.load_run(run_id) for (run_id,) in db.conn.execute("SELECT run_id FROM runs")]
        assert run.status == "Done"
        matrices = [run.identities, run.cov_query, run.aln_length, run.sim_errors]
    return rows, matrices


def _jax_run_genomes() -> dict[str, str]:
    """The JAX dry run's three FASTA texts, made as ``__graft_entry__.py``
    makes them."""
    rng2 = np.random.default_rng(5)
    base = rng2.integers(0, 4, 900, dtype=np.uint8)
    bases = np.array(list("ACGT"))
    texts = {}
    for i in range(3):
        codes = base.copy()
        mut = rng2.random(codes.size) < 0.03 * i
        codes[mut] = (codes[mut] + rng2.integers(1, 4, int(mut.sum()))) % 4
        texts[f"g{i}.fasta"] = f">g{i}\n" + "".join(bases[codes]) + "\n"
    return texts


def test_runner_step_is_the_jax_runner(tmp_path, monkeypatch) -> None:
    fasta = graft_entry.write_run_genomes(tmp_path / "genomes")
    assert {p.name: p.read_text() for p in fasta.iterdir()} == _jax_run_genomes()
    before, production = dict(os.environ), tiles.default_pair_mesh()
    part, merged = graft_entry.runner_step(_mesh(8), fasta, tmp_path / "port.db")
    assert dict(os.environ) == before
    assert tiles.default_pair_mesh() is production
    assert 0 < part < 9 and merged == 9
    # the JAX dry run's step (d), on the same genomes and its 8 devices
    monkeypatch.setattr(jax_anib, "DEVICE_BATCH", 64)
    for key, value in {"PYANI_TPU_ANIB_DEVICE": "1", "PYANI_TPU_ANIB_BATCH": "64",
                       "PYANI_TPU_PROCESS_COUNT": "2", "PYANI_TPU_PROCESS_INDEX": "0"}.items():
        monkeypatch.setenv(key, value)  # fmt: skip
    logger = logging.getLogger("dryrun")
    dbfile = tmp_path / "jax.db"
    run_id = jax_runner.start_and_run_method(logger, dbfile, fasta, "ANIb", create_db=True)
    with jax_db.Database(dbfile, logger=logger) as db:
        assert db.load_run(run_id).comparisons_count() == part
        monkeypatch.setenv("PYANI_TPU_PROCESS_INDEX", "1")
        jax_runner.resume_run(logger, db, db.load_run(run_id))
    rows, matrices = _stored(tmp_path / "port.db", port_db)
    expected_rows, expected_matrices = _stored(dbfile, jax_db)
    assert len(rows) == 9 and rows == expected_rows
    assert all(row[2] is not None for row in rows)
    for got, expected in zip(matrices, expected_matrices):
        pd.testing.assert_frame_equal(got, expected, check_exact=True)
    np.testing.assert_array_equal(np.diag(matrices[0].values), 1.0)


@pytest.mark.parametrize(("k", "shape", "batch"), [(2, (1, 2), 8), (4, (2, 2), 8), (8, (2, 4), 16)])
def test_dryrun_multichip_on_cpu_lists(k: int, shape, batch: int, capsys) -> None:
    before, production = dict(os.environ), tiles.default_pair_mesh()
    got = graft_entry.dryrun_multichip(k, devices=_cpus(k + 1))  # takes the first k
    assert dict(os.environ) == before
    assert tiles.default_pair_mesh() is production
    assert got == {"mesh": shape, "containment": (8, 8), "dp_batch": batch,
                   "merged_comparisons": 9, "sw_launches": {"alignment": 0, "runner": 0}}  # fmt: skip
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip OK: mesh {shape} ({k} devices), ")
    assert f"dp batch {batch}, " in line and "merged_comparisons=9 status=Done" in line


def test_dryrun_line_at_8_is_the_jax_dryruns(capsys, monkeypatch) -> None:
    # the JAX dry run sets anib.DEVICE_BATCH and leaves it so: restore it
    monkeypatch.setattr(jax_anib, "DEVICE_BATCH", jax_anib.DEVICE_BATCH)
    assert len(jax.devices()) >= 8
    jax_graft.dryrun_multichip(8)
    expected = capsys.readouterr().out.strip().splitlines()[-1]
    graft_entry.dryrun_multichip(8, devices=_cpus(8))
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == expected
    assert expected.startswith("dryrun_multichip OK: mesh (2, 4) (8 devices)")


def test_too_few_devices_or_no_cuda_raise(monkeypatch) -> None:
    with pytest.raises(RuntimeError, match=r"needs 4 devices but only 3 .*devices="):
        graft_entry.dryrun_multichip(4, devices=_cpus(3))
    monkeypatch.setenv(backend.ENV_DEVICE, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"no CUDA device was found; .*devices=\[torch.device\('cpu'\)\]"):
        graft_entry.dryrun_multichip(2)


def test_pair_mesh_restores_the_production_mesh(monkeypatch) -> None:
    monkeypatch.setattr(tiles, "_PAIR_MESH", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tiles.default_pair_mesh() is None
    outer, inner = _mesh(2), _mesh(4)
    with tiles.pair_mesh(outer) as mesh:
        assert mesh is outer and tiles.default_pair_mesh() is outer
        with tiles.pair_mesh(inner):
            assert tiles.default_pair_mesh() is inner
        assert tiles.default_pair_mesh() is outer
        with pytest.raises(ValueError, match="inside"), tiles.pair_mesh(inner):
            assert tiles.default_pair_mesh() is inner
            raise ValueError("inside")
        assert tiles.default_pair_mesh() is outer
    assert tiles.default_pair_mesh() is None
    monkeypatch.setenv("PYANI_TPU_MESH", "0")  # an open pair_mesh() outranks it
    with tiles.pair_mesh(outer):
        assert tiles.default_pair_mesh() is outer
    assert tiles.default_pair_mesh() is None


@pytest.mark.gpu
def test_dryrun_over_one_card_named_four_times(capsys, monkeypatch) -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv(backend.ENV_DEVICE, "cuda")
    card = torch.device("cuda", 0)
    fn, args = graft_entry.entry()
    assert all(a.device == card for a in args)
    got = graft_entry.dryrun_multichip(4, devices=[card] * 4)
    assert got["mesh"] == (2, 2) and got["merged_comparisons"] == 9
    assert got["sw_launches"]["alignment"] == 4  # one slice a mesh entry
    assert got["sw_launches"]["runner"] > 0
    assert "dryrun_multichip OK: mesh (2, 2) (4 devices)" in capsys.readouterr().out
