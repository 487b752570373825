"""Plain reference of ANIm (nucmer --mum, delta-filter -1, pyANI's scoring).

A frozen copy of the algorithm that pyANI-plus-TPU's ANIm implements,
written again on plain paths: maximal unique matches of at least 20
bases on both strands from a suffix array (prefix doubling) and its LCP
(binary lifting over the doubling ranks), in PyTorch; mgaps clustering,
the consistent anchor chain and delta-filter's chains in numpy; the gap
fills and the outward extensions as banded DPs (``banddp.py``) run for
all tasks of all pairs at once; the scoring of pyANI's ``parse_delta``.
It imports nothing of the program and reads only the FASTA files.

``compute(paths, pairs, device, params)`` returns, for each ordered pair
``(query index, subject index)``, the row the store should hold;
``prepare`` and ``rows`` are its two halves, so that the control
(``anibench/control.py``) scores the same alignments in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from anibench.reference.banddp import band_dp
from anibench.reference.fasta import Genome, read_genome, reverse_complement

MIN_MATCH = 20
MAXGAP = 90
MINCLUSTER = 65
DIAGDIFF = 5
DIAGFACTOR = 0.12
MAX_EXTENSION = 9999
EXT_BAND = 60
EXT_BREAKLEN = 200
WINDOW = 63  # mgaps looks this many matches back


@dataclass
class Alignment:
    ref_start: int
    ref_end: int
    qry_start: int
    qry_end: int
    errors: int

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


# ---------------------------------------------------------------- seeding


def _suffix_ranks(text: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The suffix array of ``text`` and the rank of every position's
    first 1, 2, 4, ... symbols, up to a length at which all differ."""
    n = text.numel()
    rank = text
    levels = [rank]
    k = 1
    while True:
        second = torch.full_like(rank, -1)
        second[: n - k] = rank[k:]
        key = rank * (int(rank.max()) + 2) + second + 1
        key_sorted, order = torch.sort(key)
        changed = torch.ones(n, dtype=torch.int64, device=text.device)
        changed[1:] = (key_sorted[1:] != key_sorted[:-1]).long()
        rank = torch.empty_like(rank)
        rank[order] = torch.cumsum(changed, 0) - 1
        levels.append(rank)
        if int(rank.max()) == n - 1:
            return order, levels
        k *= 2


def _lcp(sa: torch.Tensor, levels: list[torch.Tensor]) -> torch.Tensor:
    """lcp[i] = common prefix of suffixes sa[i - 1] and sa[i]; lcp[0] = 0."""
    n = sa.numel()
    a, b = sa[:-1], sa[1:]
    acc = torch.zeros_like(a)
    for level in range(len(levels) - 2, -1, -1):
        span = 1 << level
        pa, pb = a + acc, b + acc
        ok = (pa + span <= n) & (pb + span <= n)
        rank = levels[level]
        ok &= rank[pa.clamp(max=n - 1)] == rank[pb.clamp(max=n - 1)]
        acc += torch.where(ok, span, 0)
    return torch.cat([torch.zeros(1, dtype=acc.dtype, device=acc.device), acc])


def mums(ref: np.ndarray, qry: np.ndarray, device: torch.device) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Maximal matches of at least MIN_MATCH letters unique in both
    sequences: (ref start, query start, length). Letters other than A, C,
    G, T match nothing, not even themselves."""
    n_ref, n_qry = ref.size, qry.size
    if min(n_ref, n_qry) < MIN_MATCH:
        return (np.empty(0, np.int64),) * 3
    text = np.concatenate([ref.astype(np.int64), [96], qry.astype(np.int64), [97]])
    ambiguous = np.nonzero((text >= 4) & (text < 90))[0]
    text[ambiguous] = 100 + np.arange(ambiguous.size)
    t = torch.as_tensor(text, device=device)
    sa, levels = _suffix_ranks(t)
    lcp = _lcp(sa, levels)
    is_qry = sa > n_ref
    left = torch.where(sa > 0, t[(sa - 1).clamp(min=0)], 98)
    length = lcp[1:]
    lcp_next = torch.cat([lcp[2:], torch.zeros(1, dtype=lcp.dtype, device=lcp.device)])
    good = (
        (is_qry[:-1] != is_qry[1:])
        & (length >= MIN_MATCH)
        & (lcp[:-1] < length)
        & (lcp_next < length)
        & (left[:-1] != left[1:])
    )
    idx = good.nonzero()[:, 0]
    first, second = sa[idx], sa[idx + 1]
    swap = is_qry[idx]
    r = torch.where(swap, second, first)
    q = torch.where(swap, first, second) - n_ref - 1
    return r.cpu().numpy(), q.cpu().numpy(), length[idx].cpu().numpy()


# ------------------------------------------------------------- clustering


def clusters(r: np.ndarray, q: np.ndarray, ln: np.ndarray) -> list[np.ndarray]:
    """mgaps: each match joins the nearest of the WINDOW matches before it
    (by reference start) that lies within MAXGAP on both axes and within
    the diagonal drift allowed; groups below MINCLUSTER covered reference
    bases are dropped. Index arrays into r/q/ln, by first member."""
    if r.size == 0:
        return []
    order = np.lexsort((q, r))
    rs, qs, ls = r[order], q[order], ln[order]
    n = rs.size
    parent = np.full(n, -1, dtype=np.int64)
    for back in range(1, WINDOW + 1):
        j = np.arange(back, n)
        i = j - back
        sep = rs[j] - (rs[i] + ls[i])
        sep_q = qs[j] - (qs[i] + ls[i])
        drift = np.abs((qs[j] - rs[j]) - (qs[i] - rs[i]))
        bound = np.maximum(DIAGFACTOR * np.maximum(np.maximum(sep, sep_q), 0).astype(np.float64), DIAGDIFF)
        ok = (sep <= MAXGAP) & (sep_q <= MAXGAP) & (sep_q >= -ls[i]) & (sep >= -ls[i]) & (drift <= bound)
        take = ok & (parent[j] < 0)
        parent[j[take]] = i[take]
    root = np.arange(n)
    for j in range(n):
        if parent[j] >= 0:
            root[j] = root[parent[j]]
    groups: dict[int, list[int]] = {}
    for j in range(n):
        groups.setdefault(int(root[j]), []).append(j)
    out = []
    for members in groups.values():
        idx = order[np.asarray(members)]
        m_r, m_l = r[idx], ln[idx]
        covered, prev_end = 0, -1
        for k in np.argsort(m_r):
            s, e = int(m_r[k]), int(m_r[k] + m_l[k])
            covered += max(0, e - max(s, prev_end))
            prev_end = max(prev_end, e)
        if covered >= MINCLUSTER:
            out.append(idx)
    return out


def consistent_chain(r: np.ndarray, q: np.ndarray, ln: np.ndarray) -> list[tuple[int, int, int]]:
    """The heaviest chain of anchors increasing on both axes (weight: total
    anchor length); a later anchor takes the first best predecessor."""
    order = np.argsort(r, kind="stable")
    rs, qs, ls = r[order], q[order], ln[order]
    n = rs.size
    best = ls.astype(np.float64)
    prev = np.full(n, -1, dtype=np.int64)
    for i in range(1, n):
        ok = (rs[:i] <= rs[i]) & (qs[:i] <= qs[i]) & (rs[:i] + ls[:i] <= rs[i] + ls[i]) & (qs[:i] + ls[:i] <= qs[i] + ls[i])
        if not ok.any():
            continue
        cand = np.where(ok, best[:i] + float(ls[i]), -np.inf)
        k = int(np.argmax(cand))
        if cand[k] > best[i]:
            best[i] = cand[k]
            prev[i] = k
    end = int(np.argmax(best))
    chain = []
    while end != -1:
        chain.append((int(rs[end]), int(qs[end]), int(ls[end])))
        end = int(prev[end])
    return chain[::-1]


def delta_filter_chain(alignments: list[Alignment], axis: str) -> set[int]:
    """delta-filter's chain on one axis: starts and ends both
    non-decreasing, weight aligned length x identity^2."""
    if not alignments:
        return set()
    attr = ("ref_start", "ref_end") if axis == "ref" else ("qry_start", "qry_end")
    starts = np.array([getattr(a, attr[0]) for a in alignments], dtype=np.int64)
    ends = np.array([getattr(a, attr[1]) for a in alignments], dtype=np.int64)
    weights = np.array([(a.ref_len + a.qry_len) / 2.0 * (a.identity**2) for a in alignments])
    order = np.lexsort((ends, starts))
    best = weights.copy()
    prev = np.full(len(alignments), -1, dtype=np.int64)
    for oi in range(1, order.size):
        i = order[oi]
        before = order[:oi]
        ok = (starts[before] <= starts[i]) & (ends[before] <= ends[i])
        if not ok.any():
            continue
        cand = np.where(ok, best[before] + weights[i], -np.inf)
        k = int(np.argmax(cand))
        if cand[k] > best[i]:
            best[i] = cand[k]
            prev[i] = before[k]
    end = int(np.argmax(best))
    chain = set()
    while end != -1:
        chain.add(end)
        end = int(prev[end])
    return chain


def one_to_one(alignments: list[Alignment], keys: list[tuple[int, int]]) -> list[int]:
    """delta-filter -1: alignments on the best chain of their reference
    sequence and of their query sequence."""
    keep = []
    for part, axis in ((0, "ref"), (1, "qry")):
        groups: dict[int, list[int]] = {}
        for i, key in enumerate(keys):
            groups.setdefault(key[part], []).append(i)
        chosen: set[int] = set()
        for members in groups.values():
            chosen.update(members[i] for i in delta_filter_chain([alignments[i] for i in members], axis))
        keep.append(chosen)
    return sorted(keep[0] & keep[1])


# ------------------------------------------------------------------ scoring


def _interval_union(intervals: list[tuple[int, int]]) -> int:
    intervals = sorted(intervals)
    total = 0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            total += cur_e - cur_s + 1
            cur_s, cur_e = s, e
    return total + cur_e - cur_s + 1


def score(blocks: list[tuple[tuple[int, int], Alignment]], query: Genome, subject: Genome, dtype=np.float64) -> dict:
    """pyANI's parse_delta: identity over the kept blocks' lengths, aligned
    bases per genome by the union of intervals, coverage over genome
    length. ``dtype`` is the precision of the three quotients."""
    if not blocks:
        return {"identity": None, "aln_length": None, "sim_errors": None, "cov_query": None, "cov_subject": None}
    lengths = sum(a.ref_len + a.qry_len for _, a in blocks)
    errors = sum(a.errors for _, a in blocks)
    ref_regions: dict[int, list] = {}
    qry_regions: dict[int, list] = {}
    for (ref_id, qry_id), a in blocks:
        ref_regions.setdefault(ref_id, []).append((a.ref_start + 1, a.ref_end))
        qry_regions.setdefault(qry_id, []).append((a.qry_start + 1, a.qry_end))
    query_aligned = sum(_interval_union(v) for v in qry_regions.values())
    ref_aligned = sum(_interval_union(v) for v in ref_regions.values())
    return {
        "identity": float(dtype(lengths - 2 * errors) / dtype(lengths)),
        "aln_length": query_aligned,
        "sim_errors": errors,
        "cov_query": float(dtype(query_aligned) / dtype(query.length)),
        "cov_subject": float(dtype(ref_aligned) / dtype(subject.length)),
    }


# ----------------------------------------------------------------- pipeline


@dataclass
class _Unit:
    """One (pair, subject record, query record, strand) alignment."""

    pair: tuple[int, int]
    key: tuple[int, int]
    reverse: bool
    ref: np.ndarray
    qry: np.ndarray  # the query record, reverse-complemented on the minus strand
    qlen: int


def _fills(unit: _Unit, r, q, ln, gap_tasks: list) -> list[list]:
    """Chain each cluster and queue its gap fills; returns per cluster
    [rs, qs, prev_re, prev_qe, first gap task, gap task count]."""
    out = []
    for idx in clusters(r, q, ln):
        chain = consistent_chain(r[idx], q[idx], ln[idx])
        rs, qs, l0 = chain[0]
        prev_re, prev_qe = rs + l0, qs + l0
        first = len(gap_tasks)
        for ri, qi, li in chain[1:]:
            trim = max(prev_re - ri, prev_qe - qi, 0)
            if trim >= li:
                continue
            gap_tasks.append((unit.ref[prev_re : ri + trim], unit.qry[prev_qe : qi + trim]))
            prev_re, prev_qe = ri + li, qi + li
        out.append([rs, qs, prev_re, prev_qe, first, len(gap_tasks) - first])
    return out


def _gap_results(gap_tasks: list, device) -> list[tuple[int, int, int]]:
    """(errors, nonid, gap columns) of each end-anchored gap alignment."""
    results: list = [None] * len(gap_tasks)
    batch, where = [], []
    for t, (a, b) in enumerate(gap_tasks):
        if a.size == 0:
            results[t] = (b.size,) * 3
        elif b.size == 0:
            results[t] = (a.size,) * 3
        else:
            band = int(min(max(20, abs(a.size - b.size) + 20), max(a.size, b.size)))
            batch.append((a, b, band))
            where.append(t)
    for t, row in zip(where, band_dp(batch, free_end=False, device=device)):
        results[t] = row[3:]
    return results


def _extension_results(ext_tasks: list, device) -> list[tuple[int, int, int]]:
    """(a advance, b advance, errors) of each free-end extension: tails cut
    to the shorter one plus EXT_BREAKLEN, band 60 or the longer tail,
    given up 3 x EXT_BREAKLEN rows after the last gain."""
    results: list = [(0, 0, 0)] * len(ext_tasks)
    by_band: dict[int, tuple[list, list]] = {}
    for t, (a, b) in enumerate(ext_tasks):
        if a.size == 0 or b.size == 0:
            continue
        limit = min(a.size, b.size) + EXT_BREAKLEN
        a_t, b_t = a[:limit], b[:limit]
        band = int(min(EXT_BAND, max(a_t.size, b_t.size)))
        tasks, where = by_band.setdefault(band, ([], []))
        tasks.append((a_t, b_t, band))
        where.append(t)
    for tasks, where in by_band.values():
        for t, row in zip(where, band_dp(tasks, free_end=True, stop_rows=3 * EXT_BREAKLEN, device=device)):
            results[t] = (row[0], row[1], row[3])
    return results


def compute(paths: list[Path], pairs: list[tuple[int, int]], device, params: dict) -> dict[tuple[int, int], dict]:
    """The reference rows of the ordered pairs (query, subject) of the
    genomes in ``paths``; the subject is nucmer's reference."""
    return rows(prepare(paths, pairs, device, params), np.float64)


def rows(state, dtype) -> dict[tuple[int, int], dict]:
    """The rows from ``prepare``'s alignments, identity and coverage in
    ``dtype``."""
    genomes, blocks = state
    out = {}
    for (q_idx, s_idx), (aligns, keys) in blocks.items():
        kept = one_to_one(aligns, keys)
        out[(q_idx, s_idx)] = score([(keys[i], aligns[i]) for i in kept], genomes[q_idx], genomes[s_idx], dtype)
    return out


def prepare(paths: list[Path], pairs: list[tuple[int, int]], device, params: dict):
    """Every pair's alignment blocks with their (subject, query) record keys."""
    if params.get("mode", "mum") != "mum":
        raise ValueError("this reference seeds with maximal unique matches (--mum) only")
    device = torch.device(device)
    genomes = {i: read_genome(paths[i]) for pair in pairs for i in pair}
    units: list[_Unit] = []
    for q_idx, s_idx in pairs:
        for si, ref in enumerate(genomes[s_idx].records):
            for qi, qry in enumerate(genomes[q_idx].records):
                for reverse in (False, True):
                    codes = reverse_complement(qry) if reverse else qry
                    units.append(_Unit((q_idx, s_idx), (si, qi), reverse, ref, codes, qry.size))
    gap_tasks: list = []
    per_unit = []
    for unit in units:
        r, q, ln = mums(unit.ref, unit.qry, device)
        per_unit.append(_fills(unit, r, q, ln, gap_tasks))
    gaps = _gap_results(gap_tasks, device)
    ext_tasks = []
    for unit, fills in zip(units, per_unit):
        for rs, qs, prev_re, prev_qe, first, count in fills:
            left = min(rs, MAX_EXTENSION)
            right = min(unit.ref.size - prev_re, MAX_EXTENSION)
            ext_tasks.append((unit.ref[rs - left : rs][::-1].copy(), unit.qry[max(0, qs - MAX_EXTENSION) : qs][::-1].copy()))
            ext_tasks.append((unit.ref[prev_re : prev_re + right], unit.qry[prev_qe : prev_qe + MAX_EXTENSION]))
    exts = _extension_results(ext_tasks, device)
    blocks: dict[tuple[int, int], tuple[list, list]] = {pair: ([], []) for pair in pairs}
    e = 0
    for unit, fills in zip(units, per_unit):
        for rs, qs, prev_re, prev_qe, first, count in fills:
            (l_r, l_q, l_err), (r_r, r_q, r_err) = exts[e], exts[e + 1]
            e += 2
            errors = sum(g[0] for g in gaps[first : first + count]) + l_err + r_err
            a = Alignment(rs - l_r, prev_re + r_r, qs - l_q, prev_qe + r_q, errors)
            if unit.reverse:
                a = Alignment(a.ref_start, a.ref_end, unit.qlen - a.qry_end, unit.qlen - a.qry_start, errors)
            blocks[unit.pair][0].append(a)
            blocks[unit.pair][1].append(unit.key)
    return genomes, blocks
