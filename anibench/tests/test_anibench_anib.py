"""The ANIb cell's own pieces: its reference loads nothing of the port, a
run with one row altered or half of the pairs left out comes out as not
correct, the control (the reference in float32) fails the limits, and
B2's least time counts what the tasks need."""

from __future__ import annotations

import subprocess
import sys

import pytest

from anibench.control import control
from anibench.roofline import INT_OPS_PER_S, MEMORY_BYTES_PER_S, sw
from anibench.run import HERE, run_cell

WORKLOAD = "anib_bact4.genus"
TINY = {"length": 6000}  # the cell's four genomes, 6 fragments each
SEED = 12345


def test_the_reference_loads_nothing_of_the_port():
    code = (
        "import sys\n"
        "import anibench.reference.anib\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'pyani_plus_tpu', "
        "'pyani_plus_tpu_torch'}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True, text=True,
                          timeout=600, check=False)  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def _one_row_altered(monkeypatch, tmp_path):
    """The row of one ordered pair of the run's genomes, every time it is
    computed: one more similarity error."""
    from anibench import gen
    from anibench.run import cell, collection_of, reference_md5
    from pyani_plus_tpu_torch.methods import anib

    _bench, workload, config = cell(WORKLOAD)
    paths = gen.write_collection(collection_of(workload, config, TINY), SEED, tmp_path / "same")
    md5 = sorted(reference_md5(p) for p in paths)
    real = anib._pair_finalize

    def wrong(query, subject, *args):
        identity, aligned, errors = real(query, subject, *args)
        if (query.md5, subject.md5) == (md5[0], md5[-1]) and aligned is not None:
            errors += 1
        return identity, aligned, errors

    monkeypatch.setattr(anib, "_pair_finalize", wrong)


def _half_left_out(monkeypatch, _tmp_path):
    from pyani_plus_tpu_torch.methods import anib

    real = anib.compute
    monkeypatch.setattr(anib, "compute", lambda ctx: real(ctx)[: len(ctx.pending) // 2])


@pytest.mark.parametrize("fault", [_one_row_altered, _half_left_out])
def test_fault_is_caught(monkeypatch, tmp_path, fault):
    fault(monkeypatch, tmp_path)
    result = run_cell(WORKLOAD, SEED, 0.3, False, card=False, overrides=TINY)
    assert result["correct"] is False
    assert result["failed"] > 0


def test_control_fails():
    for seed in (1, 2, 3):
        result = control(WORKLOAD, seed, "cpu", TINY)
        assert result["correct"] is False, result
        assert result["numbers"]["identity_gap"] > result["limits"]["identity_gap"]


def test_b2_cells_are_the_full_rectangles():
    tasks = [(1020, 1330), (400, 1500), (12, 180)]
    assert sw.cells(tasks) == 1020 * 1330 + 400 * 1500 + 12 * 180
    seconds, by = sw.least(tasks)
    ops = 3 * sw.cells(tasks)
    nbytes = sum(24 + m + n + 12 for m, n in tasks)
    assert seconds == pytest.approx(max(ops / INT_OPS_PER_S, nbytes / MEMORY_BYTES_PER_S))
    assert by == "operations"
    assert sw.least([(1, 1)])[1] == "bytes"  # a one-cell task moves more than it computes
