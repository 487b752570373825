"""The control of each configuration's comparison comes out as not
correct: the reference computed in float32 where the rows are float64
fails the limits (here at a test's size; on the chip at the cell's own
size with ``python -m anibench.control``)."""

from __future__ import annotations

import pytest

from anibench.control import control


@pytest.mark.parametrize(("workload", "overrides"), [
    ("anim_bact4.strains", {"length": 6000}),
    ("sourmash_bact128.clades", {"clades": 2, "per_clade": 4, "length": 30000}),
])
def test_control_fails(workload, overrides):
    for seed in (1, 2, 3):
        result = control(workload, seed, "cpu", overrides)
        assert result["correct"] is False, result
        assert result["numbers"]["identity_gap"] > result["limits"]["identity_gap"]
