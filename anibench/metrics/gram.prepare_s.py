"""Seconds an iteration spends preparing the device Gram on the host (the
union of the hashes, their ids and the block indices): the program's span
``gram.prepare`` in ``ops.minhash.intersection_matrix_device``."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "gram.prepare")
