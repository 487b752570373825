"""FASTA parses an iteration: the program's counter ``runner.parses``
(twice the genomes while the runner parses each genome twice)."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "runner.parses", "count")
