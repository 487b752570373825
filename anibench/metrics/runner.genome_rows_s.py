"""Seconds an iteration spends in ``_setup_run``'s one-row commits (the
configuration, a row a genome and the run): the program's span
``runner.genome_rows``."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "runner.genome_rows")
