"""Seconds an iteration in ANIb's candidate enumeration less its hash joins:
the self seconds of the program's span ``anib.candidates`` (``_pair_tasks``, one
an ordered pair, on the compute thread), the Python loop over bands,
windows and N-run splits."""

from anibench import optional_spans

install = optional_spans.install


def read(data: dict) -> float | None:
    return optional_spans.read(data, "anib.candidates", "self_seconds")
