"""Thread-seconds an iteration in ANIb's winner stats, E-value gate and accept
rules (``_pair_finalize``, one span an ordered pair, on the side threads): the
program's span ``anib.stats``."""

from anibench import optional_spans

install = optional_spans.install


def read(data: dict) -> float | None:
    return optional_spans.read(data, "anib.stats")
