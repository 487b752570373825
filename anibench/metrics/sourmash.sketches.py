"""Sketches computed on the host an iteration: the program's counter
``sourmash.sketches``, one a miss of the sketch cache in
``methods.sourmash.get_sketch`` (every genome while each iteration starts
with an empty cache; a sketch read back from the cache is not counted)."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "sourmash.sketches", "count")
