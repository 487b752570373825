"""The references give the port's rows, on its CPU route, at a tiny size:
the comparison a run makes, with the cell's limits, and the integer
fields exactly."""

from __future__ import annotations

import logging

import pytest

from anibench import gen, judge
from anibench.run import cell, read_rows
from anibench.reference import anim, sourmash
from anibench.reference.fasta import read_genome


def _port_rows(tmp_path, method, params, paths):
    from pyani_plus_tpu_torch.parallel import runner

    db = tmp_path / "port.db"
    runner.start_and_run_method(logging.getLogger("test"), db, paths[0].parent, method, create_db=True,
                                cache=tmp_path / "cache", **params)
    return read_rows(db)


@pytest.mark.parametrize(("workload", "module", "collection"), [  # ANIm at 4-8% and as strains, at a tiny length
    ("anim_bact4.strains", anim, {"clades": 1, "per_clade": 4, "length": 7000, "rates": [0.04, 0.08]}),
    ("anim_bact4.strains", anim, {"clades": 1, "per_clade": 4, "length": 7000, "rates": [0.0005, 0.005]}),
    ("sourmash_bact128.clades", sourmash, {"clades": 3, "per_clade": 4, "length": 30000, "rates": [0.001, 0.08]}),
])
def test_reference_equals_the_port(tmp_path, workload, module, collection):
    _bench, _workload, config = cell(workload)
    paths = gen.write_collection(collection, 424242, tmp_path / "genomes")
    n = len(paths)
    pairs = [(q, s) for q in range(n) for s in range(n)]
    want = module.compute(paths, pairs, "cpu", config["params"])
    md5 = [read_genome(p).md5 for p in paths]
    want = {(md5[q], md5[s]): row for (q, s), row in want.items()}
    got = _port_rows(tmp_path, config["method"], config["params"], paths)
    numbers, failed = judge.compare(got, want, config["fields"], config["limits"])
    assert judge.verdict(numbers, config["limits"]) and failed == 0, numbers
    for pair, row in want.items():
        for field in ("aln_length", "sim_errors"):
            assert got[pair][field] == row[field]
    assert any(row["identity"] is not None for row in want.values())
