"""Plain reference of ANIb (Goris et al. 2007; pyANI's fragmented blastn scoring).

A frozen copy of the method that pyANI-plus-TPU's ANIb implements, written
again on plain paths: NumPy for the seeds and the bookkeeping, PyTorch for
the dynamic programs, which run for the tasks of all pairs at once, in
blocks, on the device given. It imports nothing of the program and reads
only the FASTA files. Per ordered pair (query, subject):

1. every query record is cut into fragments of ``fragsize`` letters, the
   tail included;
2. each fragment's exact 11-mer hits against each subject record, on both
   strands (the fragment and its reverse complement), give its candidates;
3. each candidate is scored by a full Smith-Waterman with blastn's scoring
   (reward 2, penalty -3, a gap of L letters costing 5 + 2L); the best
   candidate, the first on ties, is the fragment's alignment;
4. its score passes the Karlin-Altschul gate, and its columns, identities,
   mismatches and gaps come from a traceback;
5. it is kept if (columns - gaps) / fragment length > 0.7 and
   (columns - gaps - mismatches) / fragment length > 0.3;
6. identity is the mean of the kept fragments' pident, each rounded to 3
   decimals as blastn prints it, over 100; ``aln_length`` the sum of their
   columns less gaps; ``sim_errors`` the sum of their mismatches and gaps;
   coverage ``aln_length`` over each genome's length.

Where this departs from blastn, it copies the program's departures:

- seeds: every 11-mer of the fragment free of non-ACGT letters, crossing
  no fragment boundary, joined with every occurrence in the subject record;
  no word masking, no two-hit rule, no ungapped extension;
- candidates: a fragment's hits on one subject record and strand, sorted by
  diagonal (subject position less fragment position), form bands wherever
  two neighbours lie more than 48 apart; the 4 bands with the most hits
  (ties: the lower diagonal first) each give the subject window from 150
  before their lowest diagonal to 150 past their highest diagonal plus the
  fragment's length, clipped to the record; candidates in the order
  subject record, strand (plus first), band;
- blastn's final X-drop of 150 bits crosses runs of up to 55 non-ACGT
  letters and no longer: fragment and window are each split at runs of 56
  or more such letters, and every piece of one is a candidate against every
  piece of the other, in order;
- the alignment is the full local optimum of the candidate, not an
  X-drop extension from a seed; letters other than A, C, G and T never
  score as a match, yet count as identities where the letters are equal
  (N against N);
- the fragment's alignment is the cell of the highest score, the first in
  row-major order, and the traceback from it prefers the diagonal, then a
  gap in the fragment, then a gap in the window, each gap the shortest
  that gives the score;
- the gate: score >= ln(K m n / 1e-15) / lambda with lambda 0.625, K 0.41,
  m the fragment's length and n the subject's total length, no edge
  correction.

``compute(paths, pairs, device, params)`` returns, for each ordered pair
``(query index, subject index)``, the row the store should hold;
``prepare`` and ``rows`` are its two halves, so that the control
(``anibench/control.py``) computes the same rows in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import log
from pathlib import Path

import numpy as np
import torch

from anibench.reference.fasta import Genome, read_genome, reverse_complement

FRAGSIZE = 1020
WORD = 11
BAND_MERGE = 48
MAX_BANDS = 4
MARGIN = 150
N_RUN = 56
REWARD, PENALTY, GAP_OPEN, GAP_EXTEND = 2, -3, 5, 2
LAMBDA, K, EVALUE = 0.625, 0.41, 1e-15
MIN_COVERAGE, MIN_IDENTITY = 0.7, 0.3
# cells a block of the score pass holds in one row (int32 tensors of this
# many elements, about ten of them live), and bytes of the stats pass's
# matrices a block
ROW_CELLS = 1 << 25
STATS_BYTES = 6 << 30
CHECK = 32  # traceback steps between two looks for a lane still moving


# ------------------------------------------------------------------ letters


def _bank(genomes: dict[int, Genome]) -> tuple[np.ndarray, dict]:
    """All records' codes, each followed by its reverse complement, in one
    array; ``at[(genome, record)]`` = (forward start, reverse start)."""
    parts, at, offset = [], {}, 0
    for g, genome in genomes.items():
        for r, rec in enumerate(genome.records):
            at[(g, r)] = (offset, offset + rec.size)
            parts += [rec, reverse_complement(rec)]
            offset += 2 * rec.size
    bank = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return bank, at


def _kmers(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(2-bit packed value, start) of every WORD-mer of A, C, G, T only."""
    n = codes.size - WORD + 1
    if n <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    bad = np.concatenate(([0], np.cumsum(codes >= 4)))
    ok = bad[WORD:] == bad[:-WORD]
    c = (codes & 3).astype(np.int64)
    value = np.zeros(n, np.int64)
    for t in range(WORD):
        value = (value << 2) | c[t : t + n]
    start = np.flatnonzero(ok)
    return value[start], start


def _long_runs(codes: np.ndarray) -> np.ndarray:
    """(start, end) rows of the maximal runs of N_RUN or more non-ACGT letters."""
    bad = np.concatenate(([0], (codes >= 4).view(np.int8), [0]))
    edge = np.diff(bad)
    runs = np.stack([np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)], axis=1)
    return runs[runs[:, 1] - runs[:, 0] >= N_RUN]


def _pieces(codes: np.ndarray) -> list[tuple[int, int]]:
    """(offset, length) of the pieces between runs of N_RUN or more
    non-ACGT letters, in order; shorter runs stay inside their piece."""
    out, cur = [], 0
    for s, e in _long_runs(codes):
        if s > cur:
            out.append((cur, s - cur))
        cur = e
    if codes.size > cur:
        out.append((cur, codes.size - cur))
    return out


def _holds_run(runs: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Whether [lo, hi) holds N_RUN or more letters of one of the runs."""
    hit = np.zeros(lo.shape, bool)
    for s, e in runs:
        hit |= np.minimum(e, hi) - np.maximum(s, lo) >= N_RUN
    return hit


# --------------------------------------------------------------- candidates


@dataclass
class _Tasks:
    """Score tasks in candidate order, as slices of the bank."""

    q_start: np.ndarray
    q_len: np.ndarray
    s_start: np.ndarray
    s_len: np.ndarray
    frag: np.ndarray  # the fragment's index in its query genome


def _fragment_seeds(codes: np.ndarray, fragsize: int) -> tuple[list, np.ndarray, np.ndarray]:
    """Each strand's (value, fragment, position in the strand's fragment)
    of the seeds of one record, and each fragment's [start, end)."""
    length = codes.size
    lo = np.arange(0, length, fragsize, dtype=np.int64)
    hi = np.minimum(lo + fragsize, length)
    value, start = _kmers(codes)
    frag = start // fragsize
    keep = start + WORD <= hi[frag]
    plus = (value[keep], frag[keep], (start - lo[frag])[keep])
    # the reverse complement of fragment f is rc[length - hi[f]: length - lo[f]]
    value, start = _kmers(reverse_complement(codes))
    frag = (length - 1 - start) // fragsize
    keep = start + WORD <= length - lo[frag]
    minus = (value[keep], frag[keep], (start - (length - hi[frag]))[keep])
    return [plus, minus], lo, hi


def _bands(table: tuple[np.ndarray, np.ndarray], seeds: tuple) -> tuple[np.ndarray, ...]:
    """The kept bands of one record pair and strand: (fragment, rank,
    lowest diagonal, highest diagonal), ordered by fragment then rank."""
    first, t_pos = table
    value, frag, within = seeds
    lo = first[value]
    n = first[value + 1] - lo
    total = int(n.sum())
    if total == 0:
        return (np.zeros(0, np.int64),) * 4
    run_start = np.repeat(np.cumsum(n) - n, n)  # each seed's first hit among all hits
    hit_pos = t_pos[np.repeat(lo, n) + np.arange(total) - run_start]
    hit_frag = np.repeat(frag, n)
    diag = hit_pos - np.repeat(within, n)
    order = np.lexsort((diag, hit_frag))
    hit_frag, diag = hit_frag[order], diag[order]
    new = np.ones(total, bool)
    new[1:] = (hit_frag[1:] != hit_frag[:-1]) | (np.diff(diag) > BAND_MERGE)
    b_start = np.flatnonzero(new)
    b_end = np.append(b_start[1:], total)
    b_frag = hit_frag[b_start]
    count = b_end - b_start
    # rank inside the fragment: most hits first, then the lower diagonal
    order = np.lexsort((b_start, -count, b_frag))
    b_frag, b_start, b_end = b_frag[order], b_start[order], b_end[order]
    group = np.flatnonzero(np.append(True, b_frag[1:] != b_frag[:-1]))
    rank = np.arange(b_frag.size) - np.repeat(group, np.diff(np.append(group, b_frag.size)))
    keep = rank < MAX_BANDS
    return b_frag[keep], rank[keep], diag[b_start[keep]], diag[b_end[keep] - 1]


def _pair_tasks(q: int, s: int, genomes: dict, bank: np.ndarray, at: dict, fragsize: int,
                tables: dict, seeds: dict, runs: dict) -> tuple[_Tasks, np.ndarray]:
    """Every candidate of every fragment of query q against subject s, in
    candidate order, and each query fragment's length."""
    columns: dict[str, list] = {key: [] for key in ("frag", "rec", "strand", "rank", "w_lo", "w_hi", "f_lo", "f_hi", "qr")}
    frag_base = 0
    frag_sizes = []
    for qr, rec in enumerate(genomes[q].records):
        strands, f_lo, f_hi = seeds[(q, qr)]
        for sr, sub in enumerate(genomes[s].records):
            for strand in (0, 1):
                frag, rank, d_lo, d_hi = _bands(tables[(s, sr)], strands[strand])
                size = f_hi[frag] - f_lo[frag]
                columns["frag"].append(frag_base + frag)
                columns["rec"].append(np.full(frag.size, sr))
                columns["strand"].append(np.full(frag.size, strand))
                columns["rank"].append(rank)
                columns["w_lo"].append(np.maximum(0, d_lo - MARGIN))
                columns["w_hi"].append(np.minimum(sub.size, d_hi + size + MARGIN))
                columns["f_lo"].append(f_lo[frag])
                columns["f_hi"].append(f_hi[frag])
                columns["qr"].append(np.full(frag.size, qr))
        frag_base += f_lo.size
        frag_sizes.append(f_hi - f_lo)
    c = {key: np.concatenate(v) if v else np.zeros(0, np.int64) for key, v in columns.items()}
    order = np.lexsort((c["rank"], c["strand"], c["rec"], c["frag"]))
    c = {key: v[order] for key, v in c.items()}
    n = c["frag"].size
    q_len = c["f_hi"] - c["f_lo"]
    q_start = np.empty(n, np.int64)
    s_start = np.empty(n, np.int64)
    split = np.zeros(n, bool)
    for qr in range(len(genomes[q].records)):
        fwd, rev = at[(q, qr)]
        length = genomes[q].records[qr].size
        mine = c["qr"] == qr
        q_start[mine] = np.where(c["strand"][mine] == 0, fwd + c["f_lo"][mine], rev + length - c["f_hi"][mine])
        split[mine] |= _holds_run(runs[(q, qr)], c["f_lo"][mine], c["f_hi"][mine])
    for sr in range(len(genomes[s].records)):
        mine = c["rec"] == sr
        s_start[mine] = at[(s, sr)][0] + c["w_lo"][mine]
        split[mine] |= _holds_run(runs[(s, sr)], c["w_lo"][mine], c["w_hi"][mine])
    s_len = c["w_hi"] - c["w_lo"]
    # a candidate across a long run becomes its pieces' candidates, in order
    pieces = {int(t): [(q_start[t] + qo, ql, s_start[t] + so, sl)
                       for qo, ql in _pieces(bank[q_start[t] : q_start[t] + q_len[t]])
                       for so, sl in _pieces(bank[s_start[t] : s_start[t] + s_len[t]])]
              for t in np.flatnonzero(split)}  # fmt: skip
    copies = np.ones(n, np.int64)
    for t, p in pieces.items():
        copies[t] = len(p)
    where = np.cumsum(copies) - copies
    cols = [np.repeat(x, copies) for x in (q_start, q_len, s_start, s_len, c["frag"])]
    for t, p in pieces.items():
        for k, row in enumerate(p):
            for col, v in zip(cols, row):
                col[where[t] + k] = v
    sizes = np.concatenate(frag_sizes) if frag_sizes else np.zeros(0, np.int64)
    return _Tasks(*cols), sizes


# ---------------------------------------------------------------- the DPs


def _codes(bank: torch.Tensor, start: np.ndarray, length: np.ndarray, width: int, device) -> torch.Tensor:
    """The raw codes of a block's slices, padded to ``width`` with -1."""
    idx = torch.as_tensor(start, device=device)[:, None] + torch.arange(width, device=device)
    inside = torch.arange(width, device=device)[None, :] < torch.as_tensor(length, device=device)[:, None]
    raw = bank[idx.clamp_(max=max(bank.numel() - 1, 0))].to(torch.int32)
    return torch.where(inside, raw, -1)


def _prefix_max(x: torch.Tensor) -> torch.Tensor:
    """The running maximum along each row: ``torch.cummax`` on a card, a
    scan in log2(width) steps elsewhere, where the CPU's cummax runs
    element by element."""
    if x.device.type == "cuda":
        return torch.cummax(x, dim=1).values
    step = 1
    while step < x.shape[1]:
        y = torch.empty_like(x)
        y[:, :step] = x[:, :step]
        torch.maximum(x[:, step:], x[:, :-step], out=y[:, step:])
        x, step = y, 2 * step
    return x


class _Rows:
    """The affine local DP of a block of (fragment piece, window) tasks,
    one fragment letter (row) at a time over every window letter (column),
    E (a gap in the fragment) by a running maximum along the row:

        G[i, j] = max(0, H[i-1, j-1] + sub, F[i, j]),
        F[i, j] = max(H[i-1, j] - 7, F[i-1, j] - 2),
        E[i, j] = max over 1 <= j' < j of G[i, j'] - 5 - 2 (j - j'),
        H[i, j] = max(G[i, j], E[i, j]),

    H of row 0 and column 0 being 0. A letter other than A, C, G or T, or
    padding, matches nothing. The tensors are int16 where every value fits."""

    def __init__(self, q_raw: torch.Tensor, s_raw: torch.Tensor) -> None:
        b, m = q_raw.shape
        n = s_raw.shape[1]
        device = q_raw.device
        self.dtype = torch.int16 if 2 * (m + n) + 64 < 2**15 else torch.int32
        self.neg = -(2**14) if self.dtype == torch.int16 else -(2**30)
        s_key = torch.where((s_raw >= 0) & (s_raw < 4), s_raw, -1)
        # the substitution row of each fragment letter: A, C, G, T, other
        self.sub = torch.stack([torch.where(s_key == c, REWARD, PENALTY) for c in range(4)]
                               + [torch.full_like(s_key, PENALTY)]).to(self.dtype)  # fmt: skip
        self.letter = torch.where((q_raw >= 0) & (q_raw < 4), q_raw, 4).long()
        self.lanes = torch.arange(b, device=device)
        self.ge_j = (GAP_EXTEND * torch.arange(1, n + 1, device=device)).to(self.dtype)
        self.h = torch.zeros((b, n + 1), dtype=self.dtype, device=device)
        self.f = torch.full((b, n), self.neg, dtype=self.dtype, device=device)

    def next(self, i: int) -> tuple[torch.Tensor, ...]:
        """Row ``i`` (1-based): (H, G, E, H of the diagonal move)."""
        diag = self.h[:, :-1] + self.sub[self.letter[:, i - 1], self.lanes]
        self.f = torch.maximum(self.h[:, 1:] - (GAP_OPEN + GAP_EXTEND), self.f - GAP_EXTEND)
        g = torch.maximum(diag, self.f).clamp_min_(0)
        run = _prefix_max(g + self.ge_j)
        e = torch.full_like(g, self.neg)
        e[:, 1:] = run[:, :-1] - GAP_OPEN - self.ge_j[1:]
        h = torch.maximum(g, e)
        self.h[:, 1:] = h
        return h, g, e, diag


def _score_block(bank, tasks: _Tasks, idx: np.ndarray, device) -> np.ndarray:
    """(score, best row, best column) of each task: the highest cell, the
    first in row-major order, 1-based; (0, 0, 0) where nothing scores."""
    m, n = int(tasks.q_len[idx].max()), int(tasks.s_len[idx].max())
    q_raw = _codes(bank, tasks.q_start[idx], tasks.q_len[idx], m, device)
    dp = _Rows(q_raw, _codes(bank, tasks.s_start[idx], tasks.s_len[idx], n, device))
    best = torch.zeros(idx.size, dtype=dp.dtype, device=device)
    best_i = torch.zeros(idx.size, dtype=torch.int32, device=device)
    best_j = torch.zeros(idx.size, dtype=torch.int32, device=device)
    for i in range(1, m + 1):
        top, at = torch.max(dp.next(i)[0], dim=1)  # the first maximum of the row
        up = top > best
        best = torch.where(up, top, best)
        best_i = torch.where(up, i, best_i)
        best_j = torch.where(up, at.to(torch.int32) + 1, best_j)
    return torch.stack([best.to(torch.int32), best_i, best_j], 1).cpu().numpy()


def _stats_block(bank, q_start, q_len, s_start, s_len, device) -> np.ndarray:
    """(columns, identities, mismatches, gap letters) of the alignment that
    ends at the last cell of each (fragment piece, window) prefix, which
    holds its highest score. The traceback prefers the diagonal, then E,
    then F; a gap's length is the shortest that gives the cell's score."""
    b = q_start.size
    m, n = int(q_len.max()), int(s_len.max())
    q_raw = _codes(bank, q_start, q_len, m, device)
    s_raw = _codes(bank, s_start, s_len, n, device)
    dp = _Rows(q_raw, s_raw)
    H = torch.zeros((b, m + 1, n + 1), dtype=dp.dtype, device=device)
    G = torch.zeros((b, m + 1, n + 1), dtype=dp.dtype, device=device)
    by_diag = torch.zeros((b, m + 1, n + 1), dtype=torch.bool, device=device)
    by_e = torch.zeros((b, m + 1, n + 1), dtype=torch.bool, device=device)
    for i in range(1, m + 1):
        h, g, e, diag = dp.next(i)
        H[:, i, 1:] = h
        G[:, i, 1:] = g
        by_diag[:, i, 1:] = h == diag
        by_e[:, i, 1:] = h == e
    lanes = dp.lanes
    cols = torch.arange(n + 1, device=device)[None, :]
    rows = torch.arange(m + 1, device=device)[None, :]
    i = torch.as_tensor(q_len, device=device)
    j = torch.as_tensor(s_len, device=device)
    out = torch.zeros((4, b), dtype=torch.int64, device=device)  # columns, identities, mismatches, gaps
    # one move a lane a step, every lane at once; a lane that has stopped
    # stays where it is, so the steps need no look at the host but every
    # CHECK steps
    for step in range(m + n + 1):
        here = H[lanes, i, j].to(torch.int64)
        live = (i > 0) & (j > 0) & (here > 0)
        if step % CHECK == 0 and not bool(live.any()):
            break
        d = live & by_diag[lanes, i, j]
        same = q_raw[lanes, (i - 1).clamp(min=0)] == s_raw[lanes, (j - 1).clamp(min=0)]
        out[0] += d
        out[1] += d & same
        out[2] += d & ~same
        # E: the gap's start j' < j along row i of G; F: i' < i down column j of H
        along_row = live & ~d & by_e[lanes, i, j]
        along_col = live & ~d & ~by_e[lanes, i, j]
        origin = []
        for line, at, pos in ((G[lanes, i, :], cols, j), (H[lanes, :, j], rows, i)):
            p = pos[:, None]
            fits = (line.to(torch.int64) - GAP_OPEN - GAP_EXTEND * (p - at) == here[:, None]) & (at >= 2) & (at < p)
            origin.append(torch.where(fits, at, 0).max(dim=1).values.clamp(min=1))
        gap = torch.where(along_row, j - origin[0], 0) + torch.where(along_col, i - origin[1], 0)
        out[0] += gap
        out[3] += gap
        i, j = (torch.where(along_col, origin[1], i - d.long()), torch.where(along_row, origin[0], j - d.long()))
    return out.cpu().numpy().T


def _blocks(order: np.ndarray, per_lane: np.ndarray, budget: float) -> list[np.ndarray]:
    """Consecutive runs of ``order`` whose lanes times the widest lane's
    cost stay within ``budget`` (one lane at least)."""
    out, start, widest = [], 0, 0
    for k, t in enumerate(order):
        widest = max(widest, per_lane[t])
        if k > start and (k - start + 1) * widest > budget:
            out.append(order[start:k])
            start, widest = k, per_lane[t]
    if order.size:
        out.append(order[start:])
    return out


# ---------------------------------------------------------------- pipeline


def compute(paths: list[Path], pairs: list[tuple[int, int]], device, params: dict) -> dict[tuple[int, int], dict]:
    """The reference rows of the ordered pairs (query, subject) of the
    genomes in ``paths``."""
    return rows(prepare(paths, pairs, device, params), np.float64)


def rows(state, dtype) -> dict[tuple[int, int], dict]:
    """The rows from ``prepare``'s kept fragments, identity and coverage in
    ``dtype``."""
    genomes, kept = state
    out = {}
    for (q, s), frags in kept.items():
        if not frags:
            out[(q, s)] = {"identity": None, "aln_length": None, "sim_errors": None, "cov_query": None, "cov_subject": None}
            continue
        total = dtype(0.0)
        for pident, _aligned, _errors in frags:
            total = dtype(total + dtype(pident))
        aligned = sum(a for _p, a, _e in frags)
        out[(q, s)] = {
            "identity": float(dtype(total) / dtype(len(frags) * 100)),
            "aln_length": aligned,
            "sim_errors": sum(e for _p, _a, e in frags),
            "cov_query": float(dtype(aligned) / dtype(genomes[q].length)),
            "cov_subject": float(dtype(aligned) / dtype(genomes[s].length)),
        }
    return out


def prepare(paths: list[Path], pairs: list[tuple[int, int]], device, params: dict):
    """Every pair's kept fragments, in fragment order: (pident rounded to 3
    decimals, columns less gaps, mismatches plus gaps)."""
    device = torch.device(device)
    fragsize = int(params.get("fragsize") or FRAGSIZE)
    genomes = {i: read_genome(paths[i]) for pair in pairs for i in pair}
    bank_np, at = _bank(genomes)
    bank = torch.as_tensor(bank_np, device=device)
    tables, seeds, runs = {}, {}, {}
    for g, genome in genomes.items():
        for r, rec in enumerate(genome.records):
            # the record's seeds by value: those of value v are
            # positions[first[v]:first[v + 1]], in ascending order
            value, start = _kmers(rec)
            first = np.concatenate(([0], np.cumsum(np.bincount(value, minlength=4**WORD))))
            tables[(g, r)] = (first, start[np.argsort(value, kind="stable")])
            seeds[(g, r)] = _fragment_seeds(rec, fragsize)
            runs[(g, r)] = _long_runs(rec)

    # every candidate of every pair, one score pass
    per_pair = [_pair_tasks(q, s, genomes, bank_np, at, fragsize, tables, seeds, runs) for q, s in pairs]
    tasks = _Tasks(*(np.concatenate([getattr(t, k) for t, _ in per_pair])
                     for k in ("q_start", "q_len", "s_start", "s_len", "frag")))  # fmt: skip
    pair_of = np.concatenate([np.full(t.frag.size, p) for p, (t, _) in enumerate(per_pair)])
    scores = np.zeros((tasks.frag.size, 3), np.int64)
    order = np.lexsort((tasks.q_len, tasks.s_len))
    with torch.inference_mode():
        for idx in _blocks(order, tasks.s_len + 1, ROW_CELLS):
            scores[idx] = _score_block(bank, tasks, idx, device)

    # each fragment's first best candidate, through the gate
    key = pair_of * (1 << 32) + tasks.frag
    first = np.flatnonzero(np.append(True, key[1:] != key[:-1])) if key.size else np.zeros(0, np.int64)
    top = np.maximum.reduceat(scores[:, 0], first) if first.size else np.zeros(0, np.int64)
    group = np.repeat(np.arange(first.size), np.diff(np.append(first, key.size)))
    at_top = np.where(scores[:, 0] == top[group], np.arange(key.size), key.size)
    winner = np.minimum.reduceat(at_top, first) if first.size else np.zeros(0, np.int64)
    sizes = [s for _, s in per_pair]
    w_pair, w_frag = pair_of[winner], tasks.frag[winner]
    w_size = np.array([sizes[p][f] for p, f in zip(w_pair, w_frag)], np.int64)
    gate: dict[int, float] = {}  # search space -> least score
    passed = np.zeros(winner.size, bool)
    for k, (w, p, size) in enumerate(zip(winner, w_pair, w_size.tolist())):
        space = size * genomes[pairs[p][1]].length
        if space not in gate:
            gate[space] = log(K * max(space, 1) / EVALUE) / LAMBDA
        passed[k] = scores[w, 0] >= gate[space]
    winner, w_pair, w_frag, w_size = winner[passed], w_pair[passed], w_frag[passed], w_size[passed]

    # the winners' tracebacks, on the prefix that ends at their best cell
    stats = np.zeros((winner.size, 4), np.int64)
    q_len, s_len = scores[winner, 1], scores[winner, 2]
    order = np.lexsort((q_len, s_len))
    cell_bytes = 6 * (q_len + 1) * (s_len + 1)
    with torch.inference_mode():
        for idx in _blocks(order, cell_bytes, STATS_BYTES):
            w = winner[idx]
            stats[idx] = _stats_block(bank, tasks.q_start[w], q_len[idx], tasks.s_start[w], s_len[idx], device)

    kept: dict[tuple[int, int], list] = {pair: [] for pair in pairs}
    for k in np.lexsort((w_frag, w_pair)):
        columns, same, mismatches, gaps = (int(x) for x in stats[k])
        size = int(w_size[k])
        aligned = columns - gaps
        if aligned / size > MIN_COVERAGE and (aligned - mismatches) / size > MIN_IDENTITY:
            pident = float(f"{100.0 * same / columns:.3f}")
            kept[pairs[w_pair[k]]].append((pident, aligned, mismatches + gaps))
    return genomes, kept
