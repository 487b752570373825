"""Seconds an iteration packing, copying and launching ANIb's batches
(``_score_device_submit``, on the compute thread): the program's span
``anib.submit``."""

from anibench import optional_spans

install = optional_spans.install


def read(data: dict) -> float | None:
    return optional_spans.read(data, "anib.submit")
