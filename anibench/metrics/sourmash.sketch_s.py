"""Seconds an iteration spends sketching the genomes on the host: the
program's span ``sourmash.sketch``, one a genome, in
``methods.sourmash.compute``."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "sourmash.sketch")
