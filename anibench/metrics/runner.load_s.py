"""Seconds an iteration spends loading the genomes for the method
(``resume_run``'s second parse, its ``runner.parse`` spans inside): the
program's span ``runner.load``."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "runner.load")
