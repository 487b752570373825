"""Seconds an iteration spends caching the run's matrices and marking it
done: the program's span ``runner.cache``."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "runner.cache")
