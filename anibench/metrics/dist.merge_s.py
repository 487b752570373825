"""Seconds an iteration in the program's all-gather of the rows
(``distributed.allgather_comparisons``, wrapped from outside on every
rank) on the last rank to arrive, which waits for no other: each
iteration's smallest of the ranks' times, the merge's own cost."""

from anibench import rank

install = rank.install_collectives


def read(data: dict) -> float | None:
    calls = rank.calls(data, "dist.merge")
    if calls is None:
        return None
    return sum(min(each) for each in zip(*calls)) / len(calls[0])
