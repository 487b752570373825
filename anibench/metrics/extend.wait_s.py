"""Thread-seconds an iteration that the pair threads wait for B1's results
(the batch's event): the program's span ``extend.wait`` in
``ops.extend.batch_extend_collect``."""

from anibench import program_spans

install = program_spans.install


def read(data: dict) -> float | None:
    return program_spans.read(data, "extend.wait")
