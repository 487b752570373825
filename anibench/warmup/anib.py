"""ANIb's warm-up: one run of the runner over two of the cell's genomes,
cut to 300 kb, so that the native host libraries (the seed join, the
stats DP) and the Smith-Waterman kernel B2 are built (first run of a
checkout) and loaded, the card's context, the side threads and the
pinned buffers are up, and B2 has been launched."""

from __future__ import annotations

from anibench.gen import truncated_copy

WARM_LENGTH = 300_000


def warm(*, program, paths, work, run, config) -> None:
    for path in paths[:2]:
        truncated_copy(path, work / "genomes", WARM_LENGTH)
    run(work / "genomes", work / "warm.db", work / "cache")
