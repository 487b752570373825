"""A run with the timed path broken underneath comes out as not correct,
for each fault these cells can have: an answer altered where it is
produced, and half of the pairs left out. (A state left unchanged and
the exchange between chips have no counterpart in a one-card run of
whole all-vs-all jobs.)"""

from __future__ import annotations

import pytest

from anibench.run import run_cell
from anibench.tests.conftest import tiny


def _altered_anim(monkeypatch):
    from pyani_plus_tpu_torch.methods import anim

    real = anim.compute_pair

    def wrong(query, subject, mode="mum"):
        row = real(query, subject, mode)
        if row["sim_errors"] is not None and query is not subject:
            row = {**row, "sim_errors": row["sim_errors"] + 1}
        return row

    monkeypatch.setattr(anim, "compute_pair", wrong)


def _altered_sourmash(monkeypatch):
    from pyani_plus_tpu_torch.ops import minhash

    real = minhash.ani_from_counts

    def wrong(inter, sketches, ksize):
        inter = inter.copy()
        inter[0, 1] += 1
        return real(inter, sketches, ksize)

    monkeypatch.setattr(minhash, "ani_from_counts", wrong)


def _half_left_out(module_name):
    def patch(monkeypatch):
        import importlib

        method = importlib.import_module(f"pyani_plus_tpu_torch.methods.{module_name}")
        real = method.compute

        def half(ctx):
            rows = real(ctx)
            return rows[: len(rows) // 2]

        monkeypatch.setattr(method, "compute", half)

    return patch


@pytest.mark.parametrize(("workload", "method", "fault"), [
    ("anim_bact4.strains", "ANIm", _altered_anim),
    ("anim_bact4.strains", "ANIm", _half_left_out("anim")),
    ("sourmash_bact128.clades", "sourmash", _altered_sourmash),
    ("sourmash_bact128.clades", "sourmash", _half_left_out("sourmash")),
])
def test_fault_is_caught(monkeypatch, workload, method, fault):
    fault(monkeypatch)
    # at the cell's own genome count; every ordered pair is checked
    result = run_cell(workload, 12345, 0.3, False, card=False, overrides=tiny(method))
    assert result["correct"] is False
    assert result["failed"] > 0
