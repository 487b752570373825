"""The frozen generator: the same seed writes the same bytes, another
seed other genomes with the same rates, and any whole number is a seed."""

from __future__ import annotations

import numpy as np

from anibench import gen

COLLECTION = {"clades": 2, "per_clade": 3, "length": 5000, "rates": [0.01, 0.08]}


def _bytes(tmp_path, seed, sub):
    return [p.read_bytes() for p in gen.write_collection(COLLECTION, seed, tmp_path / sub)]


def test_deterministic_per_seed(tmp_path):
    assert _bytes(tmp_path, 2**31 + 17, "a") == _bytes(tmp_path, 2**31 + 17, "b")
    assert _bytes(tmp_path, 2**31 + 17, "a") != _bytes(tmp_path, 2**31 + 18, "c")


def test_every_seed_gets_the_same_rates():
    for seed in (0, 7, 2**33 + 1, -5):
        genomes = gen.collection_genomes(COLLECTION, seed, 0)
        assert len(genomes) == 3 and all(seq.size > 4000 for _, seq in genomes)
    # the rates are a fixed set that the seed only shuffles
    rng = gen.rng_for(11, 0)
    order = rng.permutation(3)
    assert sorted(np.linspace(0.01, 0.08, 3)[order]) == sorted(np.linspace(0.01, 0.08, 3))


def test_copies_match_the_program(tmp_path):
    """The frozen copies give the program's generator's genomes."""
    from pyani_plus_tpu_torch import synthetic

    rates = [0.02, 0.06]
    ours = gen.related_genomes(3000, rates, np.random.default_rng(5))
    theirs = synthetic.related_genomes(3000, rates, 5)
    assert all((a == b).all() for a, b in zip(ours, theirs))


def test_truncated_copy(tmp_path):
    path = gen.write_collection(COLLECTION, 3, tmp_path / "g")[0]
    cut = gen.truncated_copy(path, tmp_path / "cut", 1234)
    assert len(b"".join(cut.read_bytes().split(b"\n")[1:])) == 1234
