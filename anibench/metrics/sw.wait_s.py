"""Thread-seconds an iteration that ANIb's side threads wait for B2's results
(the batch's event, in ``_score_device_collect``): the program's span ``sw.wait``."""

from anibench import optional_spans

install = optional_spans.install


def read(data: dict) -> float | None:
    return optional_spans.read(data, "sw.wait")
