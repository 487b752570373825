"""Static shares of the pair grid for runs split over several hosts.

Port of ``owned_pairs`` from ``pyani_plus_tpu/parallel/tiles.py``. The
mesh sharding there (the pair Gram and the DP batches split over several
devices) is not ported yet: ROADMAP.md's item A11 will port it onto a
list of torch devices.
"""

from __future__ import annotations


def owned_pairs(n: int, process_index: int, process_count: int) -> list[tuple[int, int]]:
    """Static block ownership of the pair grid for multi-host runs.

    Host h owns every (q, s) pair with (q * n + s) % process_count == h;
    content-addressed INSERT OR IGNORE merges make overlapping ownership
    harmless.
    """
    return [
        (q, s)
        for q in range(n)
        for s in range(n)
        if (q * n + s) % process_count == process_index
    ]
