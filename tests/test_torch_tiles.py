"""The port's pair-grid mesh against the JAX package's, on the CPU.

The JAX package shards over ``jax.devices()`` (tests/conftest.py gives it
8 virtual CPU devices); the port splits over a list of torch devices,
which here names the CPU several times. Exact throughout: integer counts
equal, floats ``==``.

- ``make_mesh`` has the JAX package's (q, s) shape and device order.
- The split membership Gram (``intersection_matrix_device`` over a mesh,
  ``sharded_intersection_counts``) equals the unsplit Gram, scipy's and
  the JAX package's sharded Gram for every grid of 1 to 8 devices, with
  3 genomes (fewer than the devices) and with 10 and 12.
- ``merge_partial_matrices`` and ``sharded_containment_step`` equal the
  JAX functions on the same blocks.
- ``default_pair_mesh`` gives a mesh only for several cards in one
  process, never with ``PYANI_TPU_MESH=0`` or inside a process group.
- ``batch_sw_best`` over several devices equals one call and the native
  oracle, and ANIb's rows through a three-CPU mesh equal the JAX
  package's.
- On the card (``-m gpu``): the split Gram and the split Smith-Waterman
  over one card named twice equal one call, and a worker of local rank 1
  on a one-card machine runs on card 0.
"""

from __future__ import annotations

import functools
import logging
import types

import numpy as np
import pytest
import torch

import pyani_plus_tpu.methods.anib as jax_anib
import pyani_plus_tpu.ops.minhash as jax_minhash
import pyani_plus_tpu.parallel.tiles as jax_tiles
from pyani_plus_tpu.genomes import load_genome
from pyani_plus_tpu_torch import backend, methods
from pyani_plus_tpu_torch.methods import anib
from pyani_plus_tpu_torch.ops import minhash, sw
from pyani_plus_tpu_torch.parallel import distributed, tiles
from pyani_plus_tpu_torch.synthetic import gram_fuzz_sets, write_genome_dir

SKETCH_SETS = {
    "pool3": gram_fuzz_sets(seed=31, n=3)["pool"],  # fewer genomes than devices
    "pool12": gram_fuzz_sets(seed=32, n=12)["pool"],
    "core10": gram_fuzz_sets(seed=33, n=40)["core"],  # blocks that count 4,096
}


def _cpus(k: int) -> list[torch.device]:
    return [torch.device("cpu")] * k


def _membership(sketches) -> np.ndarray:
    union, inverse = np.unique(np.concatenate([s.hashes for s in sketches]), return_inverse=True)
    rows = np.repeat(np.arange(len(sketches)), [s.num_hashes for s in sketches])
    out = np.zeros((len(sketches), union.size), dtype=np.int8)
    out[rows, inverse] = 1
    return out


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shape_and_order_are_the_jax_packages(n: int) -> None:
    expected = jax_tiles.make_mesh(n)
    cards = [torch.device("cuda", i) for i in range(8)]  # named, not touched
    mesh = tiles.make_mesh(n, devices=cards)
    assert mesh.shape == expected.devices.shape
    assert mesh.axis_names == tuple(expected.axis_names) == ("q", "s")
    assert [[d.index for d in row] for row in mesh.devices] == [
        [d.id for d in row] for row in expected.devices
    ]
    assert tiles.make_mesh(devices=_cpus(n)).shape == expected.devices.shape


@functools.cache
def _jax_gram(name: str, block: int) -> np.ndarray:
    return jax_minhash.intersection_matrix_device(
        SKETCH_SETS[name], block=block, mesh=jax_tiles.make_mesh(8)
    )


@pytest.mark.parametrize("block", [4096, 128])
@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("name", sorted(SKETCH_SETS))
def test_split_gram_is_the_unsplit_gram(name: str, k: int, block: int) -> None:
    sketches = SKETCH_SETS[name]
    before = minhash.LAUNCHES
    got = minhash.intersection_matrix_device(sketches, block=block, mesh=tiles.make_mesh(devices=_cpus(k)))
    assert got.dtype == np.int64
    unsplit = minhash.intersection_matrix_device(sketches, block=block, mesh=None, device="cpu")
    assert np.array_equal(got, unsplit)
    assert np.array_equal(got, minhash.intersection_matrix_host(sketches))
    assert np.array_equal(got, _jax_gram(name, block))
    assert minhash.LAUNCHES == before  # counts calls on CUDA only


@pytest.mark.parametrize("k", range(1, 9))
def test_sharded_intersection_counts_is_the_jax_packages(k: int) -> None:
    sketches = SKETCH_SETS["pool12"][:11]  # 11 rows: no grid divides them
    membership = _membership(sketches)
    got = tiles.sharded_intersection_counts(membership, tiles.make_mesh(devices=_cpus(k)))
    assert got.dtype == np.int64
    assert np.array_equal(got, jax_tiles.sharded_intersection_counts(membership, jax_tiles.make_mesh(k)))
    assert np.array_equal(got, minhash.intersection_matrix_host(sketches))


def test_containment_ani_through_the_mesh_is_the_jax_packages() -> None:
    sketches = SKETCH_SETS["pool12"]
    identity, cov = minhash.containment_ani(
        sketches, use_device=True, mesh=tiles.make_mesh(devices=_cpus(6))
    )
    expected = jax_minhash.containment_ani(sketches, use_device=True, mesh=jax_tiles.make_mesh(6))
    np.testing.assert_array_equal(identity, expected[0])
    np.testing.assert_array_equal(cov, expected[1])


def test_a_device_and_a_mesh_exclude_each_other() -> None:
    with pytest.raises(ValueError, match="not both"):
        minhash.intersection_matrix_device(SKETCH_SETS["pool3"], device="cpu",
                                           mesh=tiles.make_mesh(devices=_cpus(2)))  # fmt: skip


@pytest.mark.parametrize("k", [2, 4, 8])
def test_merge_partial_matrices_is_the_jax_psum(k: int) -> None:
    rng = np.random.default_rng(k)
    n = 16
    owner = rng.integers(0, k, (n, n))
    values = rng.integers(0, 1 << 20, (n, n)).astype(np.float32)
    blocks = np.stack([np.where(owner == d, values, 0).astype(np.float32) for d in range(k)])
    got = tiles.merge_partial_matrices(blocks, tiles.make_mesh(devices=_cpus(k)))
    expected = np.asarray(jax_tiles.merge_partial_matrices(blocks, jax_tiles.make_mesh(k)))
    assert got.dtype == expected.dtype == np.float32
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(got, values)
    with pytest.raises(ValueError, match="partials for a mesh"):
        tiles.merge_partial_matrices(blocks[:-1], tiles.make_mesh(devices=_cpus(k)))


@pytest.mark.parametrize("k", [2, 6, 8])
def test_sharded_containment_step_is_the_jax_step(k: int) -> None:
    rng = np.random.default_rng(40 + k)
    n, width = 24, 300  # the JAX step needs a grid that divides the rows
    counts = rng.integers(0, 1000, (n, n)).astype(np.float32)
    step = tiles.sharded_containment_step(tiles.make_mesh(devices=_cpus(k)))
    jax_step = jax_tiles.sharded_containment_step(jax_tiles.make_mesh(k))
    for _ in range(3):  # streaming over hash blocks
        q = (rng.random((n, width)) < 0.4).astype(np.int8)
        s = (rng.random((n, width)) < 0.4).astype(np.int8)
        got = step(counts, q, s)
        expected = np.asarray(jax_step(counts, q, s))
        assert got.dtype == expected.dtype == np.float32
        np.testing.assert_array_equal(got, expected)
        np.testing.assert_array_equal(got, counts + q.astype(np.float32) @ s.astype(np.float32).T)
        counts = got


@pytest.mark.parametrize("shape", [(5, 3), (8, 3), (7, 1)])
def test_pad_to_multiple_and_owned_pairs_are_the_jax_packages(shape: tuple[int, int]) -> None:
    array = np.arange(shape[0] * shape[1], dtype=np.int8).reshape(shape)
    for multiple in (1, 2, 4):
        np.testing.assert_array_equal(
            tiles.pad_to_multiple(array, multiple, 0), jax_tiles.pad_to_multiple(array, multiple, 0)
        )
    n, hosts = shape
    for host in range(hosts):
        assert tiles.owned_pairs(n, host, hosts) == jax_tiles.owned_pairs(n, host, hosts)


@pytest.fixture
def cards(monkeypatch):
    """Fake CUDA device counts (no card is touched: the mesh only names
    devices) and no process group; returns the setter."""
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.delenv("PYANI_TPU_MESH", raising=False)
    monkeypatch.setattr(tiles, "_DEFAULT_MESH_CACHE", {})

    def set_count(count: int) -> None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)

    return set_count


def test_default_pair_mesh_takes_every_card_of_the_process(cards, monkeypatch) -> None:
    for count in (0, 1):
        cards(count)
        assert tiles.default_pair_mesh() is None
    cards(4)
    mesh = tiles.default_pair_mesh()
    assert mesh.shape == (2, 2)
    assert [d.index for d in mesh.devices.flat] == [0, 1, 2, 3]
    assert all(d.type == "cuda" for d in mesh.devices.flat)
    assert tiles.default_pair_mesh() is mesh  # cached by device tuple
    monkeypatch.setenv("PYANI_TPU_MESH", "0")
    assert tiles.default_pair_mesh() is None


def test_default_pair_mesh_is_off_in_a_process_group(cards, monkeypatch) -> None:
    cards(2)
    monkeypatch.setattr(distributed, "_initialized", True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    assert tiles.default_pair_mesh() is None
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 1)
    assert tiles.default_pair_mesh().shape == (1, 2)


def _sw_tasks(seed: int, count: int) -> list[tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    tasks = []
    for t in range(count):
        m = int(rng.integers(1, 90))
        n = int(rng.integers(1, 160))
        q = rng.integers(0, 5, m).astype(np.uint8)
        s = rng.integers(0, 6, n).astype(np.uint8)  # N and the padding code too
        if t % 2 and n > m:
            s[:m] = q
        tasks.append((q, s))
    return tasks


@pytest.mark.parametrize("k", [1, 3, 40])  # 40 devices: more than the tasks
def test_split_smith_waterman_is_one_call(k: int) -> None:
    tasks = _sw_tasks(seed=k, count=29)
    got = sw.batch_sw_best(tasks, _cpus(k))
    assert got == sw.batch_sw_best(tasks, "cpu")
    assert got == sw.batch_sw_best_host(tasks)
    bounds = sw.slice_bounds(len(tasks), k)
    assert bounds[0][0] == 0 and bounds[-1][1] == len(tasks)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert max(hi - lo for lo, hi in bounds) - min(hi - lo for lo, hi in bounds) <= 1


def test_anib_through_a_three_cpu_mesh_is_the_jax_packages(tmp_path, monkeypatch) -> None:
    genomes = [load_genome(p) for p in write_genome_dir(tmp_path, 9_000, [0.03, 0.1], seed=5)]
    run = {g.md5: g for g in genomes}
    ctx = methods.ComputeContext(
        logger=logging.getLogger(__name__), genomes=run, query_hashes=list(run),
        subject_hashes=list(run), pending={(q, s) for q in run for s in run},
        config={"fragsize": 1020},
    )  # fmt: skip
    mesh = tiles.make_mesh(devices=_cpus(3))
    monkeypatch.setattr(tiles, "default_pair_mesh", lambda: mesh)
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "1")
    split: list[list[torch.device]] = []
    real = anib.batch_sw_best_submit

    def spy(tasks, devices):
        split.append(devices)
        return real(tasks, devices)

    monkeypatch.setattr(anib, "batch_sw_best_submit", spy)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # row-serial small tensors
    try:
        got = sorted(tuple(r.values()) for r in anib.compute(ctx))
    finally:
        torch.set_num_threads(threads)
    assert split and all(device == _cpus(3) for device in split)
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "0")
    expected = sorted(tuple(r.values()) for r in jax_anib.compute(ctx))
    assert got == expected
    assert len(got) == 4 and all(row[2] is not None for row in got)


@pytest.mark.gpu
def test_split_over_one_card_named_twice() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", 0)
    sketches = gram_fuzz_sets(seed=34, n=70)["pool"]
    before = minhash.LAUNCHES
    got = minhash.intersection_matrix_device(sketches, mesh=tiles.make_mesh(devices=[card, card]))
    assert minhash.LAUNCHES == before + 1
    assert np.array_equal(got, minhash.intersection_matrix_device(sketches, mesh=None, device=card))
    assert np.array_equal(got, minhash.intersection_matrix_host(sketches))
    tasks = _sw_tasks(seed=35, count=300)
    before = sw.LAUNCHES
    got = sw.batch_sw_best(tasks, [card, card])
    assert sw.LAUNCHES == before + 2
    assert got == sw.batch_sw_best_cuda(tasks, device=card)
    assert got == sw.batch_sw_best_reference(tasks)


@pytest.mark.gpu
def test_local_rank_one_on_a_one_card_machine_runs_on_card_0(monkeypatch) -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() != 1:
        pytest.skip("needs a machine with one card")
    # worker 1 of a `launch -n 2` group, its join faked
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda *args, **kwargs: None)
    monkeypatch.setattr(distributed, "atexit", types.SimpleNamespace(register=lambda fn: None))
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "127.0.0.1:29517")
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "2")
    monkeypatch.setenv(distributed.ENV_PROCESS_ID, "1")
    assert distributed.maybe_initialize() == (1, 2)
    assert torch.cuda.current_device() == 0
    assert backend.kernel_device() == torch.device("cuda", 0)
