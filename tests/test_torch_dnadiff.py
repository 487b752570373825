"""The port's dnadiff against the JAX package: tests/test_dnadiff.py, case
for case.

The JAX cases hold dnadiff to the reference pipeline's own parse of the
viral fixtures' intermediates; those values are an external tool's and
stay with the fixtures. Here synthetic genomes stand in for the fixture
pairs, and each case holds the port's ``compute_pair`` equal to the JAX
package's (integers exact, floats ``==``), then makes the JAX case's
structural assertions on the port's result:

- ``test_rotated_pair_exact``: a genome and its copy read from another
  origin at 1% (``synthetic.write_rotated_pair``), for the rotated
  0264574 / 0266457 pair;
- ``test_self_pairs_exact``: the rotated pair's two genomes (no N)
  against themselves;
- ``test_op_pair_exact``: a pair at 8%, for the OP073605 / 0266457 pair;
- ``test_qdiff_features`` needs no fixture: the same blocks through both
  packages' feature walk.

Not ported: ``test_bad_alignments_null`` is held on a synthetic null pair
by ``tests/test_torch_bad_alignments_e2e.py`` (both CLIs, every cross row
NULL).
"""

from __future__ import annotations

import pytest

import pyani_plus_tpu.methods.dnadiff as jax_dnadiff
import pyani_plus_tpu.ops.chaining as jax_chaining
from pyani_plus_tpu.genomes import load_genome as jax_load_genome
from pyani_plus_tpu_torch.genomes import load_genome
from pyani_plus_tpu_torch.methods.dnadiff import compute_pair, qdiff_features
from pyani_plus_tpu_torch.ops.chaining import Alignment
from pyani_plus_tpu_torch.synthetic import write_genome_dir, write_rotated_pair


@pytest.fixture(scope="module")
def rotated(tmp_path_factory):
    return write_rotated_pair(tmp_path_factory.mktemp("rotated"), 30_000, 0.01, seed=21)


@pytest.fixture(scope="module")
def related(tmp_path_factory):
    return write_genome_dir(tmp_path_factory.mktemp("related"), 30_000, [0.0, 0.08], seed=22)


def _pair(query, subject) -> dict:
    got = compute_pair(load_genome(query), load_genome(subject))
    assert got == jax_dnadiff.compute_pair(jax_load_genome(query), jax_load_genome(subject))
    return got


def test_rotated_pair_exact(rotated) -> None:
    query, subject = rotated
    res = _pair(query, subject)
    length = load_genome(query).length
    assert 0.98 < res["identity"] < 1.0
    assert 0.95 * length < res["aln_length"] <= length
    assert res["sim_errors"] > 0
    assert res["cov_query"] == pytest.approx(res["aln_length"] / length)


def test_self_pairs_exact(rotated) -> None:
    for path in rotated:  # no N: every base aligns to itself
        res = _pair(path, path)
        assert res["identity"] == 1.0
        assert res["aln_length"] == load_genome(path).length
        assert res["sim_errors"] == 0


def test_op_pair_exact(related) -> None:
    res = _pair(*related)
    assert 0.85 < res["identity"] < 0.97
    assert res["sim_errors"] > 0
    assert res["aln_length"] > 0


def test_qdiff_features() -> None:
    def both(blocks, length):
        port = qdiff_features([Alignment(*b) for b in blocks], length)
        assert port == jax_dnadiff.qdiff_features([jax_chaining.Alignment(*b) for b in blocks], length)
        return port

    # two blocks with a 10 bp query gap, and unaligned ends
    assert both([(0, 100, 5, 105, 0), (110, 200, 115, 205, 0)], 250) == [
        ("BRK", 5), ("GAP", 10), ("BRK", 45)]  # fmt: skip
    # the reference walking back over aligned ground while the query advances
    assert ("DUP", 15) in both([(50, 150, 5, 105, 0), (40, 90, 120, 170, 0)], 170)
