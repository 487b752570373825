"""A group run with the timed path broken underneath comes out as not
correct, for each fault a process group can have: the exchange between
the ranks left out (rank 0 keeps only its own rows), an answer altered
where another rank produces it, and half of another rank's pairs left
out. (A state left unchanged has no counterpart in whole all-vs-all
runs.)"""

from __future__ import annotations

import pytest

from anibench.tests.conftest import run_group

EXCHANGE_LEFT_OUT = """
from pyani_plus_tpu_torch.parallel import distributed
_gather = distributed.allgather_comparisons
distributed.allgather_comparisons = lambda rows: (_gather(rows), rows)[1]
"""

# sitecustomize of rank 1: its fault is planted before anything else runs
ON_RANK_1 = """
import os
if os.environ.get("PYANI_TPU_PROCESS_ID") == "1":
    from pyani_plus_tpu_torch.methods import anib
{fault}
"""

ALTERED = """
    _finalize = anib._pair_finalize
    def _wrong(query, subject, *args):
        identity, aligned, errors = _finalize(query, subject, *args)
        return identity, aligned, errors if aligned is None else errors + 1
    anib._pair_finalize = _wrong
"""

HALF_LEFT_OUT = """
    _compute = anib.compute
    anib.compute = lambda ctx: _compute(ctx)[: len(ctx.pending) // 2]
"""


@pytest.mark.parametrize(("prelude", "hook"), [
    (EXCHANGE_LEFT_OUT, None),
    ("", ON_RANK_1.format(fault=ALTERED)),
    ("", ON_RANK_1.format(fault=HALF_LEFT_OUT)),
], ids=["exchange_left_out", "altered_on_rank_1", "half_left_out_on_rank_1"])
def test_fault_is_caught(tmp_path, prelude, hook):
    out = run_group(tmp_path, prelude=prelude, hook=hook)
    result = out["result"]
    assert result["_notes"]["error"] is None  # the group ran to its end: the judge finds the fault
    assert result["correct"] is False and result["failed"] > 0
    assert out["left"] == []
