"""Ordered pairs stored a second over the traced window: every pair of
every iteration that began, over the time from the first one's start to
the last one's end, as ``pairs_per_s`` is taken end to end. For the cells
whose host-bound runs spread too widely for an end-to-end bound on the
rate (PERF.md), which hold it here."""


def read(data: dict) -> float | None:
    if not data["iterations"] or data["window_s"] <= 0:
        return None
    return len(data["iterations"]) * data["genomes"] ** 2 / data["window_s"]
