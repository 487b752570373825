"""ANIm's warm-up: one run of the runner over two of the cell's genomes,
cut to 300 kb, so that the native host libraries and the extension kernel
B1 are built (first run of a checkout) and loaded, the card's context and
the pair threads' streams are up, and B1 has been launched."""

from __future__ import annotations

from anibench.gen import truncated_copy

WARM_LENGTH = 300_000


def warm(*, program, paths, work, run, config) -> None:
    for path in paths[:2]:
        truncated_copy(path, work / "genomes", WARM_LENGTH)
    run(work / "genomes", work / "warm.db", work / "cache")
