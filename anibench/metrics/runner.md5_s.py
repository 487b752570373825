"""Seconds an iteration spends in the MD5 index of the FASTA directory: the
program's span ``runner.md5`` in ``runner.index_fasta_directory``."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "runner.md5")
