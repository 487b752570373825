"""Seconds an iteration that a rank spends in the program's broadcast of
rank 0's pending pairs (``distributed.broadcast_pending``, wrapped from
outside on every rank), the largest rank's. Rank 0 enters it once its
store is set up; the others wait there for rank 0."""

from anibench import rank

install = rank.install_collectives


def read(data: dict) -> float | None:
    calls = rank.calls(data, "dist.pending")
    if calls is None:
        return None
    return max(sum(c) for c in calls) / len(calls[0])
