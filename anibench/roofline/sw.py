"""The Smith-Waterman kernel B2's least time for the tasks it was given.

Each task (a fragment piece of m letters against a subject window of n)
is a full local DP of m x n cells, with no band, whatever computes it: 3
integer instructions a cell (the kernel's six for a pair of 16-bit cells
packed in one register). The bytes are what the kernel must read and
write once: 24 bytes of offsets and lengths a task, its m + n code bytes,
and 12 bytes of result (score and best cell).
"""

from __future__ import annotations

from anibench.roofline import least_seconds

OPS_PER_CELL = 3


def cells(tasks: list[tuple[int, int]]) -> int:
    """DP cells of (fragment letters, window letters) tasks."""
    return sum(m * n for m, n in tasks)


def least(tasks: list[tuple[int, int]]) -> tuple[float, str]:
    nbytes = sum(24 + m + n + 12 for m, n in tasks)
    return least_seconds(cells(tasks) * OPS_PER_CELL, nbytes)
