"""Exact k-mer seed finding: hash join + diagonal clustering.

Replaces BLAST's word lookup (word size 11 for ``-task blastn``) and
feeds the banded DP: for a query fragment vs a subject sequence, find
the diagonals carrying exact k-mer matches and group them into candidate
bands. Plus and minus strands are handled by seeding the reverse
complement of the query separately.

Packing: a k-mer over codes 0..3 packs into 2k bits of an int64; windows
containing N (code 4) are excluded.
"""

from __future__ import annotations

import numpy as np

from pyani_plus_tpu_torch.genomes import CODE_N

WORD_SIZE = 11  # blastn -task blastn default


def pack_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(packed_values, positions) of all N-free k-mers of a code array."""
    n = codes.size - k + 1
    if n <= 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    c = codes.astype(np.int64)
    invalid = (codes >= CODE_N).astype(np.int64)
    csum = np.concatenate(([0], np.cumsum(invalid)))
    valid = (csum[k:] - csum[:-k]) == 0
    packed = np.zeros(n, dtype=np.int64)
    for j in range(k):
        packed |= (c[j : j + n] & 3) << (2 * (k - 1 - j))
    pos = np.nonzero(valid)[0]
    return packed[pos], pos


class SeedIndex:
    """Sorted k-mer table of one subject sequence for hash-join lookups."""

    def __init__(self, codes: np.ndarray, k: int = WORD_SIZE) -> None:
        self.k = k
        self.length = int(codes.size)
        values, positions = pack_kmers(codes, k)
        order = np.argsort(values, kind="stable")
        self.values = values[order]
        self.positions = positions[order]

    def hits(self, query_codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """All (query_pos, subject_pos) exact k-mer matches."""
        q_values, q_pos = pack_kmers(query_codes, self.k)
        return self.hits_packed(q_values, q_pos)

    def hits_packed(
        self, q_values: np.ndarray, q_pos: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Hash-join pre-packed query k-mers against the table."""
        if q_values.size == 0 or self.values.size == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        lo = np.searchsorted(self.values, q_values, side="left")
        hi = np.searchsorted(self.values, q_values, side="right")
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        qp = np.repeat(q_pos, counts)
        # Within-group offsets without a Python loop: arange(total) minus
        # each group's flat start, plus its table start.
        keep = counts > 0
        starts = np.repeat(lo[keep], counts[keep])
        flat_starts = np.repeat(
            np.concatenate(([0], np.cumsum(counts[keep])[:-1])), counts[keep]
        )
        offsets = np.arange(total, dtype=np.int64) - flat_starts + starts
        sp = self.positions[offsets]
        return qp, sp


def candidate_bands(
    q_pos: np.ndarray,
    s_pos: np.ndarray,
    *,
    band_merge: int = 48,
    max_bands: int = 4,
) -> list[tuple[int, int, int]]:
    """Cluster seed hits by diagonal; return up to max_bands candidates.

    Returns (diag_lo, diag_hi, n_seeds) tuples sorted by seed count
    descending, where diag = subject_pos - query_pos. Diagonals within
    ``band_merge`` of each other merge into one band (indel slack).
    """
    if q_pos.size == 0:
        return []
    diags_sorted = np.sort(s_pos - q_pos)
    return bands_from_sorted_diags(
        diags_sorted, band_merge=band_merge, max_bands=max_bands
    )


def bands_from_sorted_diags(
    diags_sorted: np.ndarray,
    *,
    band_merge: int = 48,
    max_bands: int = 4,
) -> list[tuple[int, int, int]]:
    """Band clustering over an already-sorted diagonal array (vectorised).

    Runs are detected with a diff/flatnonzero scan -- no per-group array
    materialisation (np.split was the ANIb profile's top cost). The tie
    rule matches the original list.sort: equal counts keep ascending
    diagonal order.

    >>> import numpy as np
    >>> bands_from_sorted_diags(np.array([0, 3, 200, 201, 202]))
    [(200, 202, 3), (0, 3, 2)]
    >>> bands_from_sorted_diags(np.array([0, 3, 5, 200, 201, 202]))
    [(0, 5, 3), (200, 202, 3)]
    >>> bands_from_sorted_diags(np.array([7]), max_bands=2)
    [(7, 7, 1)]
    """
    n = diags_sorted.size
    if n == 0:
        return []
    gap = np.diff(diags_sorted) > band_merge
    starts = np.flatnonzero(np.concatenate(([True], gap)))
    ends = np.concatenate((starts[1:], [n]))
    counts = ends - starts
    if counts.size > max_bands:
        top = np.argsort(-counts, kind="stable")[:max_bands]
    else:
        top = np.argsort(-counts, kind="stable")
    return [
        (
            int(diags_sorted[starts[i]]),
            int(diags_sorted[ends[i] - 1]),
            int(counts[i]),
        )
        for i in top
    ]
