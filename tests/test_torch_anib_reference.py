"""The benchmark's plain ANIb (``anibench/reference/anib.py``) against the
port's stored rows, on the CPU.

Three genomes of 20 kb: two of one ancestor at the genus cell's rates
(4% and 8% substitutions, indels at a twentieth of that, N runs and IUPAC
letters, as ``anibench/gen`` makes them), the first with a run of 64 N
planted inside its third fragment, and one of an unrelated ancestor. The
port runs all nine ordered pairs through ``runner.start_and_run_method``
(the native host scorer, as the CPU route runs it); the reference
computes a related pair both ways, a self-pair and an unrelated pair,
which the port stores as NULL. Integers must be equal, identity and
coverage within the cell's limits (1e-12).
"""

from __future__ import annotations

import logging

import numpy as np
import pytest

from anibench import gen, judge
from anibench.reference import anib as reference
from anibench.reference.fasta import read_genome
from anibench.run import cell, read_rows
from pyani_plus_tpu_torch.parallel import runner

LENGTH = 20_000
N_RUN = (2_100, 2_164)  # inside the third fragment, [2040, 3060)
PAIRS = [(0, 1), (1, 0), (0, 0), (0, 2)]


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    directory = tmp_path_factory.mktemp("anib_reference")
    collection = {"clades": 2, "per_clade": 2, "length": LENGTH, "rates": [0.04, 0.08]}
    related = gen.collection_genomes(collection, 2147520001, 0)
    unrelated = gen.collection_genomes(collection, 2147520001, 1)[0]
    first = related[0][1].copy()
    first[N_RUN[0] : N_RUN[1]] = ord("N")
    named = [(related[0][0], first), related[1], unrelated]
    return [gen.write_fasta(directory / f"{name}.fna", name, seq) for name, seq in named]


def test_reference_equals_the_port(genomes, tmp_path):
    _bench, _workload, config = cell("anib_bact4.genus")
    codes = read_genome(genomes[0]).records[0]
    assert (codes[N_RUN[0] : N_RUN[1]] >= 4).all() and (codes > 4).any()  # the N run and IUPAC letters
    want = reference.compute(genomes, PAIRS, "cpu", config["params"])
    db = tmp_path / "port.db"
    runner.start_and_run_method(logging.getLogger(__name__), db, genomes[0].parent, "ANIb", create_db=True,
                                **config["params"])  # fmt: skip
    got = read_rows(db)
    assert len(got) == 9
    md5 = [read_genome(p).md5 for p in genomes]
    want = {(md5[q], md5[s]): row for (q, s), row in want.items()}
    numbers, failed = judge.compare(got, want, config["fields"], config["limits"])
    assert judge.verdict(numbers, config["limits"]) and failed == 0, numbers
    for pair, row in want.items():
        assert (got[pair]["aln_length"], got[pair]["sim_errors"]) == (row["aln_length"], row["sim_errors"])
    related, self_pair, unrelated = want[(md5[0], md5[1])], want[(md5[0], md5[0])], want[(md5[0], md5[2])]
    assert 0.85 < related["identity"] < 0.97
    assert self_pair["identity"] == 1.0 and self_pair["sim_errors"] == 0
    assert all(v is None for v in unrelated.values())


def test_the_long_run_splits_fragment_and_window():
    codes = np.zeros(300, np.uint8)
    codes[100:156] = 78  # 56 N: a split
    codes[200:255] = 78  # 55 N: crossed
    assert reference._pieces(codes) == [(0, 100), (156, 144)]
    assert reference._pieces(codes[120:]) == [(0, 180)]  # 36 N left at the edge: whole
    assert reference._pieces(np.full(60, 78, np.uint8)) == []
