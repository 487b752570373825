"""Seconds an iteration in ANIb's native sort and hash join of the seeds
(``_record_strand_diags``, inside ``anib.candidates``): the program's span
``anib.join``."""

from anibench import optional_spans

install = optional_spans.install


def read(data: dict) -> float | None:
    return optional_spans.read(data, "anib.join")
