"""Seconds an iteration spends writing the comparisons to the store: the
program's span ``runner.store`` around ``insert_comparisons``."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "runner.store")
