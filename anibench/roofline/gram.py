"""The sourmash Gram's least time, from what its inputs need.

All-pairs |A n B| of N sorted hash sets, whatever computes it: each
sketch read once (8 bytes a hash), the N x N counts written once (8
bytes each), and |A| + |B| comparisons to intersect each ordered pair
(a merge of two sorted sets), one integer operation each.
"""

from __future__ import annotations

from anibench.roofline import least_seconds


def least(sizes: list[int]) -> tuple[float, str]:
    n, total = len(sizes), sum(sizes)
    ops = 2 * n * total  # sum over the n^2 ordered pairs of |A| + |B|
    return least_seconds(ops, 8 * total + 8 * n * n)
