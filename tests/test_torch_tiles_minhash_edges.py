"""The port's mesh factorisation, pair ownership and FracMinHash edges
against the JAX package: tests/test_tiles_minhash_edges.py, case for case.

Each case gives both packages the same input and holds the outputs equal
(integers exact, floats ``==`` with NaN in the same places), then makes
the JAX case's assertions on the port's. The port's mesh is a grid of
torch devices: the JAX package's ``make_mesh(n)`` over its 8 virtual CPU
devices maps to ``make_mesh(devices=[cpu] * n)``. The sketches of the
containment cases come from ``synthetic.gram_edge_sets``; each goes
through the host Gram (``use_device=False``) and through the port's
device Gram on the CPU (``use_device=True``, the code the card runs).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pyani_plus_tpu.ops.minhash as jax_minhash
import pyani_plus_tpu.parallel.tiles as jax_tiles
from pyani_plus_tpu.genomes import load_genome as jax_load_genome
from pyani_plus_tpu_torch.genomes import load_genome
from pyani_plus_tpu_torch.ops import minhash
from pyani_plus_tpu_torch.parallel import tiles
from pyani_plus_tpu_torch.synthetic import gram_edge_sets


def _containment(name: str, use_device: bool) -> tuple[np.ndarray, np.ndarray]:
    sketches = gram_edge_sets()[name]
    jax_sketches = [jax_minhash.Sketch(s.md5, s.ksize, s.scaled, s.hashes) for s in sketches]
    identity, cov = minhash.containment_ani(sketches, use_device=use_device)
    jax_identity, jax_cov = jax_minhash.containment_ani(jax_sketches, use_device=False)
    np.testing.assert_array_equal(identity, jax_identity)  # NaN where NaN
    np.testing.assert_array_equal(cov, jax_cov)
    return identity, cov


def test_make_mesh_factorisations() -> None:
    for n, want in ((1, (1, 1)), (2, (1, 2)), (4, (2, 2)), (6, (2, 3)), (8, (2, 4))):
        mesh = tiles.make_mesh(devices=[torch.device("cpu")] * n)
        assert mesh.shape == jax_tiles.make_mesh(n).devices.shape == want, n
        assert mesh.axis_names == ("q", "s")


def test_owned_pairs_partition_is_exact() -> None:
    n, k = 7, 3
    seen = []
    for h in range(k):
        mine = tiles.owned_pairs(n, h, k)
        assert mine == jax_tiles.owned_pairs(n, h, k)
        assert mine  # every host gets work at this size
        seen.extend(mine)
    assert sorted(seen) == [(q, s) for q in range(n) for s in range(n)]


def test_owned_pairs_single_host_owns_all() -> None:
    assert tiles.owned_pairs(5, 0, 1) == jax_tiles.owned_pairs(5, 0, 1)
    assert len(tiles.owned_pairs(5, 0, 1)) == 25


def test_max_hash_for_scaled() -> None:
    for scaled in (1, 10, 300, 1000):
        assert minhash.max_hash_for_scaled(scaled) == jax_minhash.max_hash_for_scaled(scaled)
    assert minhash.max_hash_for_scaled(1) == 2**64 - 1
    assert abs(minhash.max_hash_for_scaled(1000) / 2**64 - 1e-3) < 1e-6


@pytest.mark.parametrize("use_device", [False, True])
def test_containment_identical_sketches(use_device: bool) -> None:
    identity, cov = _containment("identical", use_device)
    assert identity.shape == (2, 2)
    assert np.allclose(identity, 1.0) and np.allclose(cov, 1.0)


@pytest.mark.parametrize("use_device", [False, True])
def test_containment_disjoint_sketches_nan(use_device: bool) -> None:
    identity, _cov = _containment("disjoint", use_device)
    assert np.isnan(identity[0, 1]) and np.isnan(identity[1, 0])
    assert identity[0, 0] == 1.0


@pytest.mark.parametrize("use_device", [False, True])
def test_containment_subset_max_symmetry(use_device: bool) -> None:
    """identity takes the larger containment, so it is symmetric even when
    the sketches nest; cov is the query's containment ** (1/k)."""
    identity, cov = _containment("subset", use_device)
    assert np.isclose(identity[0, 1], identity[1, 0])
    assert np.isclose(identity[0, 1], 1.0)
    assert np.isclose(cov[1, 0], 1.0)  # the half in the whole: all of it
    assert np.isclose(cov[0, 1], 0.5 ** (1 / 31))  # the whole in its half


@pytest.mark.parametrize("use_device", [False, True])
def test_empty_sketch_gives_nan_row(use_device: bool) -> None:
    identity, _cov = _containment("empty", use_device)
    assert np.isnan(identity[0, 1]) and np.isnan(identity[1, 0])


def test_sketch_genome_empty_and_tiny(tmp_path) -> None:
    """Genomes shorter than k, or all N, sketch to no hash in either package."""
    (tmp_path / "tiny.fasta").write_text(">t\nACGT\n")
    (tmp_path / "n.fasta").write_text(">n\n" + "N" * 200 + "\n")
    for name in ("tiny.fasta", "n.fasta"):
        sk = minhash.sketch_genome(load_genome(tmp_path / name), 31, 1000)
        jax_sk = jax_minhash.sketch_genome(jax_load_genome(tmp_path / name), 31, 1000)
        assert sk.hashes.size == jax_sk.hashes.size == 0, name


def test_scaled_monotone_sketch_size(tmp_path) -> None:
    """Smaller scaled keeps more hashes; scaled = 1 keeps every distinct
    canonical k-mer: the same hashes in both packages."""
    rng = np.random.default_rng(7)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 5000))
    (tmp_path / "g.fasta").write_text(f">g\n{seq}\n")
    genome, jax_genome = load_genome(tmp_path / "g.fasta"), jax_load_genome(tmp_path / "g.fasta")
    sizes = []
    for scaled in (1, 10, 100):
        hashes = minhash.sketch_genome(genome, 31, scaled).hashes
        assert np.array_equal(hashes, jax_minhash.sketch_genome(jax_genome, 31, scaled).hashes)
        sizes.append(hashes.size)
    assert sizes[0] >= sizes[1] >= sizes[2]
    assert sizes[0] > 4500
