"""The comparison that decides ``correct``: stored rows against the reference.

Every number compared has its limit in the configuration's file
(``limits``), and PERF.md gives the readings each limit was set from:

- ``missing_rows``: ordered pairs that an iteration's store lacks, over
  all N^2 pairs of every iteration (limit 0);
- ``null_mismatch``: checked fields that one side leaves empty and the
  other fills (limit 0);
- ``identity_gap``: the widest absolute gap of the identity;
- ``coverage_gap``: the widest absolute gap of the query and subject
  coverage;
- ``count_gap``: the widest gap of an integer field (aligned length,
  similarity errors), for methods that fill them.
"""

from __future__ import annotations

import math

FLOAT_FIELDS = {"identity": "identity_gap", "cov_query": "coverage_gap", "cov_subject": "coverage_gap"}
INT_FIELDS = {"aln_length": "count_gap", "sim_errors": "count_gap"}


def compare(stored: dict, reference: dict, fields: list[str], limits: dict[str, float]) -> tuple[dict[str, float], int]:
    """The numbers of one iteration's rows against the reference, over the
    reference's pairs that were stored, and how many of them are out of a
    limit. ``missing_rows`` is left at 0 for the caller, who counts the
    missing pairs over all N^2.

    ``stored`` and ``reference`` map (query MD5, subject MD5) to rows."""
    numbers = {"missing_rows": 0.0, "null_mismatch": 0.0}
    numbers.update({FLOAT_FIELDS.get(f) or INT_FIELDS[f]: 0.0 for f in fields})
    bad_pairs = 0
    for pair, want in reference.items():
        got = stored.get(pair)
        if got is None:  # counted with all pairs by the caller
            continue
        bad = False
        for field in fields:
            x, y = got[field], want[field]
            if (x is None) != (y is None):
                numbers["null_mismatch"] += 1
                bad = True
                continue
            if x is None:
                continue
            name = FLOAT_FIELDS.get(field) or INT_FIELDS[field]
            gap = abs(float(x) - float(y))
            if math.isnan(gap):
                gap = math.inf
            numbers[name] = max(numbers[name], gap)
            bad |= gap > limits[name]
        bad_pairs += bad
    return numbers, bad_pairs


def merge(into: dict[str, float], numbers: dict[str, float]) -> None:
    """Counts add up over iterations; gaps take the widest."""
    for name, value in numbers.items():
        if name in ("missing_rows", "null_mismatch"):
            into[name] = into.get(name, 0.0) + value
        else:
            into[name] = max(into.get(name, 0.0), value)


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    return all(numbers[name] <= limits[name] for name in numbers)
