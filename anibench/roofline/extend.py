"""The extension kernel B1's least time for the tasks it was given.

Each task (a tail of m rows against one of n columns) runs its band of
121 cells a row until 600 rows past its best cell (the give-up rule:
3 x ANIm's breaklen of 200) or its last row: min(m, best row + 600)
rows. A band cell needs 60 integer instructions (M, D and I with three
payloads each, the scan element, the best key). The bytes are what the
kernel must read and write once: 24 bytes of offsets and lengths a
task, its m + n code bytes, and 20 bytes of result.
"""

from __future__ import annotations

from anibench.roofline import least_seconds

BAND_COLUMNS = 121
OPS_PER_CELL = 60
STOP_ROWS = 600


def cells(tasks: list[tuple[int, int, int]]) -> int:
    """Band cells of (rows, columns, rows advanced to the best cell) tasks."""
    return BAND_COLUMNS * sum(min(m, best + STOP_ROWS) for m, _n, best in tasks)


def least(tasks: list[tuple[int, int, int]]) -> tuple[float, str]:
    nbytes = sum(24 + m + n + 20 for m, n, _ in tasks)
    return least_seconds(cells(tasks) * OPS_PER_CELL, nbytes)
