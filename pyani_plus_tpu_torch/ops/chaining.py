"""Anchor clustering and chain filtering (mgaps / delta-filter analogues).

- :func:`cluster_matches` -- greedy chaining of maximal matches into
  clusters, following nucmer's mgaps rules: successive matches join when
  the separation along the reference is <= maxgap and the diagonal drift
  is <= max(diagdiff, diagfactor * separation); clusters below
  mincluster total match length are dropped. (nucmer 3.23 defaults:
  -c 65, -g 90, -D 5, -d 0.12.)
- :func:`one_to_one` -- delta-filter ``-1`` analogue: the intersection
  of the maximum-weight consistent chains along the reference axis and
  the query axis (weight = aligned length x identity^2, delta-filter's
  scoring), allowing bounded overlap.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAXGAP = 90
MINCLUSTER = 65
DIAGDIFF = 5
DIAGFACTOR = 0.12
BREAKLEN = 200


@dataclass
class Alignment:
    """One pairwise alignment block (0-based half-open on both axes)."""

    ref_start: int
    ref_end: int
    qry_start: int
    qry_end: int
    errors: int  # similarity errors: negative-score columns incl. N-vs-N
    reverse: bool = False  # query on the minus strand
    gap_columns: int = 0  # total gap columns (subset of errors)
    # Character non-identities (nucmer delta header field 1): gap columns
    # plus substitutions whose characters differ -- N-vs-N is the same
    # character so it is NOT counted here, unlike in ``errors`` (field 2).
    # None means "no masked bases involved": identical to ``errors``.
    nonid: int | None = None

    @property
    def char_errors(self) -> int:
        """Non-identity columns (show-coords %idy numerator basis)."""
        return self.errors if self.nonid is None else self.nonid

    @property
    def columns(self) -> int:
        """Total alignment columns: (ref_len + qry_len + gapcols) / 2."""
        return (self.ref_len + self.qry_len + self.gap_columns) // 2

    @property
    def ref_len(self) -> int:
        return self.ref_end - self.ref_start

    @property
    def qry_len(self) -> int:
        return self.qry_end - self.qry_start

    @property
    def identity(self) -> float:
        total = self.ref_len + self.qry_len
        return (total - 2 * self.errors) / total if total else 0.0


def cluster_matches(
    r: np.ndarray,
    q: np.ndarray,
    length: np.ndarray,
    *,
    maxgap: int = MAXGAP,
    mincluster: int = MINCLUSTER,
    diagdiff: int = DIAGDIFF,
    diagfactor: float = DIAGFACTOR,
) -> list[np.ndarray]:
    """Group matches into clusters; returns index arrays into r/q/length."""
    if r.size == 0:
        return []
    order = np.lexsort((q, r))
    r_s, q_s, l_s = r[order], q[order], length[order]
    n = r_s.size

    from pyani_plus_tpu_torch.native import cluster_roots_native

    roots = cluster_roots_native(r_s, q_s, l_s, maxgap, diagdiff, diagfactor)
    if roots is None:  # pragma: no cover - no compiler
        parent = np.arange(n)

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        # mgaps joins each match to the best earlier match within
        # constraints; a bounded backward window keeps this near-linear.
        for j in range(1, n):
            dj = q_s[j] - r_s[j]
            for i in range(j - 1, max(-1, j - 64), -1):
                sep = r_s[j] - (r_s[i] + l_s[i])
                if sep > maxgap:
                    # matches sorted by ref start; once separation from
                    # the closest candidate exceeds maxgap we can stop
                    # scanning only if ends are monotone -- they aren't,
                    # so keep a bounded window instead of breaking.
                    continue
                di = q_s[i] - r_s[i]
                sep_q = q_s[j] - (q_s[i] + l_s[i])
                if sep_q > maxgap or sep_q < -l_s[i] or sep < -l_s[i]:
                    continue
                if abs(dj - di) <= max(
                    diagdiff, diagfactor * max(sep, sep_q, 0)
                ):
                    pa, pb = find(i), find(j)
                    if pa != pb:
                        parent[pb] = pa
                    break
        roots = np.fromiter((find(i) for i in range(n)), np.int64, n)

    groups: dict[int, list[int]] = {}
    for i in range(n):
        groups.setdefault(int(roots[i]), []).append(i)
    clusters = []
    for members in groups.values():
        idx = order[np.asarray(members)]
        # Cluster weight: total match length less pairwise ref overlaps
        m_r = r[idx]
        m_l = length[idx]
        sub = np.argsort(m_r)
        covered = 0
        prev_end = -1
        for k in sub:
            s, e = int(m_r[k]), int(m_r[k] + m_l[k])
            covered += max(0, e - max(s, prev_end))
            prev_end = max(prev_end, e)
        if covered >= mincluster:
            clusters.append(idx)
    return clusters


def _best_chain(alignments: list[Alignment], axis: str) -> set[int]:
    """Maximum-weight consistent chain along one axis (delta-filter -r/-q).

    Weight = aligned length * identity^2; consistency = starts strictly
    increase and overlap with the previous chosen alignment is < 50% of
    either interval (delta-filter's default overlap tolerance).
    """
    if not alignments:
        return set()
    if axis == "ref":
        ivals = [(a.ref_start, a.ref_end) for a in alignments]
    else:
        ivals = [(a.qry_start, a.qry_end) for a in alignments]
    weights = [
        (a.ref_len + a.qry_len) / 2.0 * (a.identity**2) for a in alignments
    ]
    starts = np.fromiter((iv[0] for iv in ivals), np.int64, len(ivals))
    ends = np.fromiter((iv[1] for iv in ivals), np.int64, len(ivals))
    # lexsort is stable, matching sorted(..., key=ivals[i]) exactly
    order = np.lexsort((ends, starts))

    from pyani_plus_tpu_torch.native import chain_dp_native

    native = chain_dp_native(starts, ends, np.asarray(weights), order)
    if native is not None:
        best_score, prev = native
    else:  # pragma: no cover - no compiler
        best_score = [0.0] * len(alignments)
        prev = [-1] * len(alignments)
        for oi, i in enumerate(order):
            best_score[i] = weights[i]
            for j in (order[k] for k in range(oi)):
                # delta-filter LIS: starts and ends both non-decreasing;
                # the default overlap tolerance is 100% so any overlap is
                # allowed while the chain stays monotone on this axis.
                if ivals[j][0] <= ivals[i][0] and ivals[j][1] <= ivals[i][1]:
                    cand = best_score[j] + weights[i]
                    if cand > best_score[i]:
                        best_score[i] = cand
                        prev[i] = j
    end = int(np.argmax(best_score))
    chain = set()
    while end != -1:
        chain.add(end)
        end = prev[end]
    return chain


def _axis_keep(
    alignments: list[Alignment],
    keys: list[tuple[int, int]] | None,
    axis: str,
) -> set[int]:
    """Per-sequence best chains along one axis (delta-filter -r / -q).

    delta-filter computes the LIS separately FOR EACH reference sequence
    (-r, candidates = that ref contig's alignments to every query) and
    for each query sequence (-q); with ``keys`` (per-alignment
    (ref_id, qry_id)) the grouping matches that on multi-contig genomes.
    Without keys all alignments share one axis (single-contig case).
    """
    if keys is None:
        return _best_chain(alignments, axis)
    groups: dict[int, list[int]] = {}
    part = 0 if axis == "ref" else 1
    for i, key in enumerate(keys):
        groups.setdefault(key[part], []).append(i)
    keep: set[int] = set()
    for members in groups.values():
        chain = _best_chain([alignments[i] for i in members], axis)
        keep.update(members[i] for i in chain)
    return keep


def one_to_one(
    alignments: list[Alignment],
    keys: list[tuple[int, int]] | None = None,
) -> list[Alignment]:
    """delta-filter -1: intersection of the ref-axis and qry-axis chains."""
    keep = _axis_keep(alignments, keys, "ref") & _axis_keep(
        alignments, keys, "qry"
    )
    return [a for i, a in enumerate(alignments) if i in keep]


def many_to_many(
    alignments: list[Alignment],
    keys: list[tuple[int, int]] | None = None,
) -> list[Alignment]:
    """delta-filter -m: union of the ref-axis and qry-axis chains."""
    keep = _axis_keep(alignments, keys, "ref") | _axis_keep(
        alignments, keys, "qry"
    )
    return [a for i, a in enumerate(alignments) if i in keep]
