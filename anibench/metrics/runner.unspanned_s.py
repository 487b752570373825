"""Seconds an iteration spends outside the runner's spans: an iteration
less the top-level spans ``runner.md5``, ``runner.parse`` (the first
parse), ``runner.genome_rows``, ``runner.load``, ``runner.compute``,
``runner.store`` and ``runner.cache``. What the program's trace cannot
see yet (the store's opening, the pending set, the progress bar, the
harness's cache clearing between iterations)."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.unspanned(data)
