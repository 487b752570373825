"""Thread-seconds an iteration in ANIm's extension tasks on the host,
summed over the pair threads: the self seconds of the program's span
``anim.extend`` (building the tasks, the extensions that stay on the
host), less its wait for B1 (``extend.wait``)."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "anim.extend", "self_seconds")
