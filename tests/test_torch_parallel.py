"""The port's pair-grid mesh, worker pool and profiler against the JAX
package: tests/test_parallel.py, case for case.

The JAX package shards over 8 virtual CPU devices (tests/conftest.py);
the port's mesh is a grid of torch devices, here the CPU named 8 times,
as ``tests/test_torch_tiles.py`` builds it. Each case gives both packages
the same input and holds the outputs equal, exact:

- the sharded counts and the production containment over the mesh
  (``tiles.pair_mesh`` sets the port's production mesh, as the JAX
  package's 8 virtual devices set its own), on synthetic genomes where
  the JAX case reads the reference's viral fixtures;
- the batched Smith-Waterman split over the 8-entry mesh (13 tasks, not
  a multiple of 8) against the host stats DP and the JAX sharded scores;
- ``PYANI_TPU_MESH=0`` (read at ``parallel/tiles.py:119``) against a
  process that holds 8 cards (the cards are named, not touched);
- ``PYANI_TPU_PROFILE``: a ``torch.profiler`` trace, where the JAX package
  writes a JAX one; rows equal;
- the pair worker pool against the sequential rows and the JAX package's,
  fastANI on synthetic genomes.

Not ported here, held elsewhere on the same input:
``test_graft_entry_single_chip`` by
``tests/test_torch_graft_entry.py::test_entry_is_the_jax_entry`` (the
port's ``entry`` on the CPU equal to ``jax.jit`` of the JAX step), and
``test_graft_dryrun_multichip`` by
``tests/test_torch_graft_entry.py::test_dryrun_line_at_8_is_the_jax_dryruns``
(the port's dry run over 8 CPU entries prints the JAX dry run's line).
"""

from __future__ import annotations

import json
import logging

import numpy as np
import pytest
import torch

import pyani_plus_tpu.methods as jax_methods
import pyani_plus_tpu.ops.minhash as jax_minhash
import pyani_plus_tpu.parallel.tiles as jax_tiles
from pyani_plus_tpu.genomes import load_genome as jax_load_genome
from pyani_plus_tpu_torch import backend, methods
from pyani_plus_tpu_torch.genomes import load_genome
from pyani_plus_tpu_torch.ops import dp, minhash, sw
from pyani_plus_tpu_torch.parallel import distributed, tiles
from pyani_plus_tpu_torch.synthetic import SW_PAD_CODE, write_genome_dir

CPUS = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def mesh() -> tiles.Mesh:
    return tiles.make_mesh(devices=CPUS)


@pytest.fixture(scope="module")
def genome_dir(tmp_path_factory):
    return write_genome_dir(tmp_path_factory.mktemp("genomes"), 20_000, [0.02, 0.1], seed=8)[0].parent


def test_mesh_shape(mesh) -> None:
    assert mesh.size == jax_tiles.make_mesh(8).devices.size == 8
    assert mesh.shape == jax_tiles.make_mesh(8).devices.shape
    assert mesh.axis_names == ("q", "s")


def test_sharded_counts_match_host(mesh) -> None:
    rng = np.random.default_rng(0)
    membership = (rng.random((13, 300)) < 0.1).astype(np.int8)
    counts = tiles.sharded_intersection_counts(membership, mesh)
    expected = membership.astype(np.int64) @ membership.astype(np.int64).T
    assert np.array_equal(counts, expected)
    assert np.array_equal(counts, jax_tiles.sharded_intersection_counts(membership, jax_tiles.make_mesh(8)))


def test_production_containment_shards_over_mesh(mesh, genome_dir) -> None:
    """The production sourmash path (``containment_ani`` -> device Gram,
    ``mesh="auto"``) splits over the production mesh: 3 genomes, fewer
    than the devices, exact against the host Gram and the JAX mesh."""
    paths = sorted(genome_dir.glob("*.fna"))
    sketches = [minhash.sketch_genome(load_genome(p), 31, 300) for p in paths]
    jax_sketches = [jax_minhash.sketch_genome(jax_load_genome(p), 31, 300) for p in paths]
    assert jax_tiles.default_pair_mesh() is not None  # 8 virtual devices: the JAX mesh is on
    assert tiles.default_pair_mesh() is None  # the CPU requested: no mesh unless set
    with tiles.pair_mesh(mesh):
        assert tiles.default_pair_mesh() is mesh
        inter_mesh = minhash.intersection_matrix_device(sketches)
        id_mesh, cov_mesh = minhash.containment_ani(sketches, use_device=True)
    inter_host = minhash.intersection_matrix_host(sketches)
    assert np.array_equal(inter_mesh, inter_host)
    assert np.array_equal(inter_mesh, jax_minhash.intersection_matrix_device(jax_sketches))
    id_host, cov_host = minhash.containment_ani(sketches, use_device=False)
    jax_id, jax_cov = jax_minhash.containment_ani(jax_sketches, use_device=True)
    for got in (id_host, jax_id):
        np.testing.assert_array_equal(id_mesh, got)
    for got in (cov_host, jax_cov):
        np.testing.assert_array_equal(cov_mesh, got)


def test_owned_pairs_partition() -> None:
    n, hosts = 7, 3
    all_pairs = [p for h in range(hosts) for p in tiles.owned_pairs(n, h, hosts)]
    assert all_pairs == [p for h in range(hosts) for p in jax_tiles.owned_pairs(n, h, hosts)]
    assert sorted(all_pairs) == [(q, s) for q in range(n) for s in range(n)]


def test_pair_worker_pool_equals_sequential(monkeypatch, genome_dir) -> None:
    """``PYANI_TPU_PAIR_WORKERS=2`` gives the sequential rows (the pool only
    reorders completion), which are the JAX package's."""
    paths = sorted(genome_dir.glob("*.fna"))

    def run(package, load) -> list[dict]:
        genomes = {p.stem: load(p) for p in paths}
        names = sorted(genomes)
        method = package.get_method("fastANI")
        ctx = package.ComputeContext(
            logger=logging.getLogger(__name__), genomes=genomes, query_hashes=names,
            subject_hashes=names, pending={(q, s) for q in names for s in names},
            config=method.configuration(),
        )  # fmt: skip
        return sorted(method.compute(ctx), key=lambda r: (r["query_hash"], r["subject_hash"]))

    monkeypatch.delenv("PYANI_TPU_PAIR_WORKERS", raising=False)
    sequential = run(methods, load_genome)
    assert sequential == run(jax_methods, jax_load_genome)
    monkeypatch.setenv("PYANI_TPU_PAIR_WORKERS", "2")
    assert run(methods, load_genome) == sequential


def test_batched_dp_shards_over_mesh() -> None:
    """The ANIb batch scorer split over the 8-entry mesh (13 tasks: not a
    multiple of 8) returns the host DP's scores and the JAX package's
    sharded scores."""
    from pyani_plus_tpu.ops.dp_jax import PAD_CODE, batch_local_align_scores

    assert PAD_CODE == SW_PAD_CODE
    rng = np.random.default_rng(3)
    b, m, n = 13, 96, 160
    queries = np.full((b, m), PAD_CODE, np.uint8)
    subjects = np.full((b, n), PAD_CODE, np.uint8)
    for i in range(b):
        qlen = int(rng.integers(40, m))
        q = rng.integers(0, 4, qlen, dtype=np.uint8)
        s = np.concatenate([q, rng.integers(0, 4, n - qlen, dtype=np.uint8)])
        idx = rng.integers(0, qlen, max(1, qlen // 10))
        s[idx] = (s[idx] + 1) % 4
        queries[i, :qlen] = q
        subjects[i] = s[:n]
    jax = np.asarray(batch_local_align_scores(queries, subjects))
    got = sw.batch_sw_best(list(zip(queries, subjects)), list(tiles.make_mesh(devices=CPUS).devices.flat))
    assert len(got) == b
    for i in range(b):
        q, s = queries[i][queries[i] != PAD_CODE], subjects[i][subjects[i] != PAD_CODE]
        stats = dp.local_align_stats(q, s)
        assert got[i][0] == int(jax[i]) == (stats.score if stats else 0), i


def test_mesh_opt_out_env(monkeypatch) -> None:
    """``PYANI_TPU_MESH=0`` turns the production mesh off; unset, a process
    with 8 cards gets the JAX package's 8-device grid."""
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setenv(backend.ENV_DEVICE, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(tiles, "_DEFAULT_MESH_CACHE", {})
    monkeypatch.setenv("PYANI_TPU_MESH", "0")
    jax_tiles._DEFAULT_MESH_CACHE.clear()
    assert tiles.default_pair_mesh() is None
    assert jax_tiles.default_pair_mesh() is None
    monkeypatch.delenv("PYANI_TPU_MESH")
    jax_tiles._DEFAULT_MESH_CACHE.clear()
    mesh, jax_mesh = tiles.default_pair_mesh(), jax_tiles.default_pair_mesh()
    jax_tiles._DEFAULT_MESH_CACHE.clear()
    assert mesh is not None and mesh.size == jax_mesh.devices.size == 8
    assert mesh.shape == jax_mesh.devices.shape
    assert [d.index for d in mesh.devices.flat] == [d.id for d in jax_mesh.devices.flat]


def test_profile_trace_capture(monkeypatch, tmp_path) -> None:
    """``PYANI_TPU_PROFILE=<dir>`` wraps the compute phase in a profiler
    trace in both packages: the port's ``trace-<pid>.json`` loads as a
    chrome trace; both runs end Done with equal rows."""
    import os

    from pyani_plus_tpu.db import Database as JaxDatabase
    from pyani_plus_tpu.methods import sourmash as jax_sourmash
    from pyani_plus_tpu.parallel import runner as jax_runner
    from pyani_plus_tpu_torch.db import Database
    from pyani_plus_tpu_torch.methods import sourmash
    from pyani_plus_tpu_torch.parallel import runner

    (tmp_path / "g").mkdir()
    (tmp_path / "g" / "a.fasta").write_text(">a\n" + "ACGT" * 400 + "\n")
    (tmp_path / "g" / "b.fasta").write_text(">b\n" + "ACCT" * 400 + "\n")
    logger = logging.getLogger(__name__)
    rows = {}
    for tag, (db_class, run_module, method) in {
        "port": (Database, runner, sourmash), "jax": (JaxDatabase, jax_runner, jax_sourmash),
    }.items():  # fmt: skip
        monkeypatch.setenv("PYANI_TPU_PROFILE", str(tmp_path / f"trace_{tag}"))
        db = db_class(tmp_path / f"{tag}.sqlite", create=True)
        h2f = run_module.index_fasta_directory(logger, tmp_path / "g")
        run = run_module._setup_run(logger, db, tmp_path / "g", method.configuration(scaled=10),
                                    h2f, None, "cmd", "sourmash")  # fmt: skip
        run_module.resume_run(logger, db, run, hash_to_filename=h2f, cache=tmp_path / tag)
        assert db.load_run(run.run_id).status == "Done"
        assert list((tmp_path / f"trace_{tag}").rglob("*")), f"{tag}: the trace directory is empty"
        rows[tag] = sorted(tuple(row) for row in db.load_run(run.run_id).comparisons())
        db.close()
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 4
    trace = tmp_path / "trace_port" / f"trace-{os.getpid()}.json"
    assert isinstance(json.loads(trace.read_text())["traceEvents"], list)
