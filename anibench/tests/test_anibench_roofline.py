"""The kernels' least times on hand-sized inputs."""

from __future__ import annotations

import pytest

from anibench.roofline import INT_OPS_PER_S, MEMORY_BYTES_PER_S, extend, gram, least_seconds


def test_least_seconds_takes_the_larger():
    assert least_seconds(INT_OPS_PER_S, 1.0) == (pytest.approx(1.0), "operations")
    assert least_seconds(1.0, MEMORY_BYTES_PER_S) == (pytest.approx(1.0), "bytes")


def test_extension_cells_follow_the_give_up_rule():
    # a task that ends at its last row, one that gives up 600 rows past
    # its best, and one whose best is its first row
    tasks = [(300, 310, 290), (5000, 5000, 1000), (900, 900, 0)]
    assert extend.cells(tasks) == 121 * (300 + 1600 + 600)
    seconds, by = extend.least(tasks)
    assert by == "operations"
    assert seconds == pytest.approx(121 * 2500 * 60 / INT_OPS_PER_S)


def test_gram_counts_what_the_inputs_need():
    sizes = [1000, 2000, 3000]
    seconds, by = gram.least(sizes)
    ops = 2 * 3 * 6000  # each of the 9 ordered pairs: |A| + |B|
    nbytes = 8 * 6000 + 8 * 9
    assert seconds == pytest.approx(max(ops / INT_OPS_PER_S, nbytes / MEMORY_BYTES_PER_S))
    assert by == ("operations" if ops / INT_OPS_PER_S >= nbytes / MEMORY_BYTES_PER_S else "bytes")
