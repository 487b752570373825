"""Seconds an iteration in the subjects' seed indexes (``SeedIndex``, once a
column, on the compute thread): the program's span ``anib.index``."""

from anibench import optional_spans

install = optional_spans.install


def read(data: dict) -> float | None:
    return optional_spans.read(data, "anib.index")
