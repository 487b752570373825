"""The window's arithmetic: iterations begin while less than the window
has passed, and the rate counts every pair of every iteration that began
over the time to the end of the last one."""

from __future__ import annotations

from anibench.run import pairs_per_s, timed_window


class Clock:
    def __init__(self) -> None:
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


def test_iterations_begin_inside_the_window():
    clock = Clock()

    def iterate(_k):
        clock.now += 7.0

    durations, window, error = timed_window(20.0, iterate, clock)
    assert durations == [7.0, 7.0, 7.0] and window == 21.0 and error is None  # the third began at 14 s
    assert pairs_per_s(len(durations), 4, window) == 3 * 16 / 21.0


def test_a_long_iteration_still_counts_whole():
    clock = Clock()

    def iterate(_k):
        clock.now += 25.0

    durations, window, _ = timed_window(20.0, iterate, clock)
    assert durations == [25.0] and window == 25.0


def test_a_failed_iteration_ends_the_window():
    clock = Clock()

    def iterate(k):
        clock.now += 5.0
        if k == 1:
            raise SystemExit("incomplete results")

    durations, window, error = timed_window(60.0, iterate, clock)
    assert durations == [5.0] and window == 10.0 and "incomplete results" in error
