"""Seconds an iteration the compute thread waits for the oldest group in
flight (the lookahead pipeline's back-pressure): the program's span
``anib.drain``. Large where the side threads set the pace."""

from anibench import optional_spans

install = optional_spans.install


def read(data: dict) -> float | None:
    return optional_spans.read(data, "anib.drain")
