"""The cards' idle share of the window in a process group: on each rank's
card one less the union of its kernel, memcpy and memset intervals in
that rank's trace over its window, in percent, the mean of the ranks'."""

from anibench import rank


def read(data: dict) -> float | None:
    timelines = rank.per_rank(data, "timeline")
    if timelines is None or any(t["window_s"] <= 0 for t in timelines):
        return None
    return sum(100.0 * (1.0 - t["busy_s"] / t["window_s"]) for t in timelines) / len(timelines)
