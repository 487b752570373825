"""Seconds an iteration in the method on the slowest rank of a process
group (the program's span ``runner.compute``, over the rank's share of
the pairs), the largest rank's."""

from anibench import program_spans, rank

install = program_spans.install


def read(data: dict) -> float | None:
    seconds = rank.span_seconds(data, ("runner.compute",))
    return None if seconds is None else max(seconds)
