"""Seconds an iteration spends parsing FASTA files, both parses of every
genome (``_setup_run``'s and ``resume_run``'s): the program's span
``runner.parse``, one a ``load_genome`` call."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "runner.parse")
