"""The card's idle share of the window: one less the union of its kernel,
memcpy and memset intervals in the profiler's trace over the window, in
percent."""


def read(data: dict) -> float | None:
    timeline = data["timeline"]
    if timeline["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - timeline["busy_s"] / timeline["window_s"])
