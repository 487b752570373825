"""The port's alignment blocks against the JAX package's:
tests/test_delta_parity.py's case on synthetic genomes.

The JAX case holds every block of ANIm (``--mum``, ``one_to_one``) and of
dnadiff (``--maxmatch``, ``many_to_many``) to nucmer's and delta-filter's
``.filter`` files in the reference fixtures: (ref start, ref end, query
start, query end, errors, indel columns). Those files are an external
tool's output and stay with the fixtures. Here the same two sets are
stood in for by synthetic genomes, ``viral_example`` by three related
genomes at 2-8% substitutions with indels, N runs and IUPAC letters, and
``bad_alignments`` by a null pair of unrelated genomes; for every ordered
pair of contigs the port's filtered blocks, in the JAX case's tuple
form, must equal the JAX package's, in both modes.
"""

from __future__ import annotations

from pathlib import Path

import pytest

import pyani_plus_tpu.methods.anim as jax_anim
import pyani_plus_tpu.ops.chaining as jax_chaining
from pyani_plus_tpu.genomes import load_genome as jax_load_genome
from pyani_plus_tpu_torch.genomes import load_genome
from pyani_plus_tpu_torch.methods.anim import align_sequences
from pyani_plus_tpu_torch.ops.chaining import many_to_many, one_to_one
from pyani_plus_tpu_torch.synthetic import write_genome_dir, write_null_pair

FILTERS = {"mum": (one_to_one, jax_chaining.one_to_one),
           "maxmatch": (many_to_many, jax_chaining.many_to_many)}  # fmt: skip


@pytest.fixture(scope="module")
def sets(tmp_path_factory) -> dict[str, list[Path]]:
    root = tmp_path_factory.mktemp("delta")
    return {
        "viral_example": write_genome_dir(root / "viral", 20_000, [0.02, 0.05, 0.08], seed=31),
        "bad_alignments": write_null_pair(root / "bad", 20_000, seed=32),
    }


def _blocks(align, filt, ref_codes, qry_codes, mode: str) -> list[tuple[int, ...]]:
    out = []
    for a in filt(align(ref_codes, qry_codes, mode=mode)):
        qc = (a.qry_end, a.qry_start + 1) if a.reverse else (a.qry_start + 1, a.qry_end)
        out.append((a.ref_start + 1, a.ref_end, *qc, a.errors, a.gap_columns))
    return sorted(out)


@pytest.mark.parametrize(("subdir", "mode"), [("ANIm", "mum"), ("dnadiff", "maxmatch")])
@pytest.mark.parametrize("fixset", ["viral_example", "bad_alignments"])
def test_blocks_bit_identical(sets, fixset: str, subdir: str, mode: str) -> None:
    port_filter, jax_filter = FILTERS[mode]
    genomes = {p: (load_genome(p), jax_load_genome(p)) for p in sets[fixset]}
    total = 0
    for qp in genomes:
        for sp in genomes:
            (q, jq), (s, js) = genomes[qp], genomes[sp]
            ours, theirs = [], []
            for s_rec, js_rec in zip(s.records, js.records):
                for q_rec, jq_rec in zip(q.records, jq.records):
                    ours += _blocks(align_sequences, port_filter, s_rec.codes, q_rec.codes, mode)
                    theirs += _blocks(jax_anim.align_sequences, jax_filter, js_rec.codes, jq_rec.codes, mode)
            assert sorted(ours) == sorted(theirs), f"{qp.stem} vs {sp.stem} ({subdir})"
            total += len(ours)
            if fixset == "bad_alignments" and qp != sp:
                assert not ours  # unrelated genomes: no block
    assert total
