"""Seconds an iteration spends in the device Gram, from its submit to the
counts on the host: the program's span ``gram.device`` in
``ops.minhash.intersection_matrix_device``."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "gram.device")
