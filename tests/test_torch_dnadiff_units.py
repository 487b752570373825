"""The port's dnadiff unit pieces against the JAX package:
tests/test_dnadiff_units.py, case for case.

The qdiff feature walk (BRK, GAP, DUP, INV) and the delta-filter chain
filters (``one_to_one``, ``many_to_many``) change AlignedBases silently
when wrong. Each case builds the same blocks in both packages, runs the
port's ``methods/dnadiff.qdiff_features`` and ``ops/chaining`` filters and
the JAX package's, holds the outputs equal (features as tuples, kept
blocks by position), and makes the JAX case's assertions on the port's.

One case more, ``test_block_end_gaps_extend_as_the_jax_package``: the
free-end extension at a block's ends, where the alignment opens or closes
with a gap (``synthetic.extension_end_gap_tasks``), through the port's
CPU dispatch against the JAX package's ``extend_errors`` and the native
kernel.
"""

from __future__ import annotations

import pytest
import torch

import pyani_plus_tpu.methods.dnadiff as jax_dnadiff
import pyani_plus_tpu.ops.chaining as jax_chaining
from pyani_plus_tpu.ops.extend import extend_errors as jax_extend_errors
from pyani_plus_tpu_torch.methods.dnadiff import qdiff_features
from pyani_plus_tpu_torch.ops import extend as ext
from pyani_plus_tpu_torch.ops.chaining import Alignment, many_to_many, one_to_one
from pyani_plus_tpu_torch.synthetic import extension_end_gap_tasks


def _aln(rs, re, qs, qe, errors=0, reverse=False, **kwargs):
    """The block in both packages: (port Alignment, JAX Alignment)."""
    fields = dict(ref_start=rs, ref_end=re, qry_start=qs, qry_end=qe, errors=errors,
                  reverse=reverse, **kwargs)  # fmt: skip
    return Alignment(**fields), jax_chaining.Alignment(**fields)


def _qdiff(blocks, length: int) -> list[tuple]:
    port = qdiff_features([p for p, _ in blocks], length)
    assert port == jax_dnadiff.qdiff_features([j for _, j in blocks], length)
    return port


def _kept(filt: str, blocks, **kwargs) -> set[int]:
    """Positions of the blocks that the port's filter keeps, equal to the
    JAX filter's."""
    port = {id(a) for a in {"one": one_to_one, "many": many_to_many}[filt]([p for p, _ in blocks], **kwargs)}
    jax_filter = {"one": jax_chaining.one_to_one, "many": jax_chaining.many_to_many}[filt]
    jax = {id(a) for a in jax_filter([j for _, j in blocks], **kwargs)}
    kept = {i for i, (p, _) in enumerate(blocks) if id(p) in port}
    assert kept == {i for i, (_, j) in enumerate(blocks) if id(j) in jax}
    return kept


def test_qdiff_empty_and_full_cover() -> None:
    assert _qdiff([], 1000) == []
    assert _qdiff([_aln(0, 1000, 0, 1000)], 1000) == []


def test_qdiff_brk_at_both_ends() -> None:
    assert _qdiff([_aln(100, 900, 50, 850)], 1000) == [("BRK", 50), ("BRK", 150)]


def test_qdiff_gap_between_blocks() -> None:
    assert _qdiff([_aln(0, 400, 0, 400), _aln(500, 900, 450, 850)], 850) == [("GAP", 50)]


def test_qdiff_negative_gap_for_overlap() -> None:
    assert _qdiff([_aln(0, 400, 0, 400), _aln(500, 900, 380, 780)], 780) == [("GAP", -20)]


def test_qdiff_dup_when_reference_rewinds() -> None:
    """The reference walking back while the query advances is a DUP."""
    assert _qdiff([_aln(0, 400, 0, 400), _aln(100, 300, 420, 620)], 620) == [("DUP", 20)]


def test_qdiff_inv_on_strand_flip() -> None:
    blocks = [_aln(0, 400, 0, 400), _aln(500, 900, 450, 850, reverse=True)]
    assert _qdiff(blocks, 850) == [("INV", 50)]


def _with_nested_repeat():
    # three consistent blocks and a repeat whose reference interval lies
    # inside block a's: not on one monotone reference-axis chain with a,
    # but on the query axis it chains after block c
    return [_aln(0, 100, 0, 100), _aln(100, 200, 100, 200), _aln(200, 300, 200, 300),
            _aln(20, 80, 400, 460)]  # fmt: skip


def test_one_to_one_drops_nested_repeat_many_keeps_it() -> None:
    """-1 (both axes' chains) drops the nested repeat, -m (either) keeps it."""
    blocks = _with_nested_repeat()
    assert _kept("one", blocks) == {0, 1, 2}
    assert _kept("many", blocks) == {0, 1, 2, 3}


def test_chain_allows_overlap_but_not_nesting() -> None:
    big, overlapping, nested = _aln(0, 100, 0, 100), _aln(50, 150, 50, 150), _aln(20, 80, 20, 80)
    assert len(_kept("one", [big, overlapping])) == 2
    assert len(_kept("one", [big, nested])) == 1


def test_one_to_one_groups_by_sequence_keys() -> None:
    """With (ref_id, qry_id) keys the chains are per sequence: a nested
    block conflicts only on the same contig."""
    a, nested = _aln(0, 100, 0, 100), _aln(20, 80, 400, 460)
    assert _kept("one", [a, nested], keys=[(0, 0), (0, 0)]) == {0}
    assert _kept("one", [a, nested], keys=[(0, 0), (1, 1)]) == {0, 1}


def test_alignment_identity_and_columns() -> None:
    for block in _aln(0, 100, 0, 98, errors=5, gap_columns=2):
        assert block.columns == 100
        assert abs(block.identity - (198 - 10) / 198) < 1e-12
        assert block.char_errors == 5
    port, jax = _aln(0, 10, 0, 10, errors=3, nonid=1)
    assert port.char_errors == jax.char_errors == 1  # N-vs-N columns are not char-different
    assert port.identity == jax.identity


@pytest.fixture
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_block_end_gaps_extend_as_the_jax_package(one_torch_thread) -> None:
    tasks = extension_end_gap_tasks(6)
    got = ext.batch_extend(tasks, "cpu")
    assert got == ext.batch_extend_host(tasks)
    assert got == [tuple(jax_extend_errors(a, b)) for a, b in tasks]
