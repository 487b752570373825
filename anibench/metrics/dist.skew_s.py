"""Seconds an iteration that the first rank to reach the program's
all-gather of the rows waits for the last: each iteration's largest of
the ranks' all-gather times less its smallest (``dist.merge_s``), the
time the barrier costs the group for its slowest rank."""

from anibench import rank

install = rank.install_collectives


def read(data: dict) -> float | None:
    calls = rank.calls(data, "dist.merge")
    if calls is None:
        return None
    return sum(max(each) - min(each) for each in zip(*calls)) / len(calls[0])
