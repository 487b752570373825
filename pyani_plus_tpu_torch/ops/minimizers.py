"""Windowed (winnowed) minimizer extraction, MashMap/fastANI-compatible.

fastANI's mapping core (vendored MashMap2) sketches sequences with
winnowed minimizers: at each k-mer position take the canonical hash
min(murmur64(kmer), murmur64(revcomp)), skip positions where the two
hashes are equal (strand-symmetric k-mers), and over every window of
``w`` consecutive positions record the *rightmost minimal* hash, deduping
consecutive windows that pick the same position. (Reference behaviour of
``CommonFunc::addMinimizers``; replaced tool: fastANI, see SURVEY.md
section 2.2 row fastANI.)

The hash here is MurmurHash3 x64-128 (low word, seed 42) over the raw
uppercase sequence bytes -- N and other ambiguity codes are hashed
literally, as fastANI does (this is what produces its self-vs-self < 100%
anomaly on N-runs, reference test_self_vs_self.py:122).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pyani_plus_tpu_torch.ops.murmur3 import murmur64_numpy

_COMPLEMENT = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMPLEMENT[_a] = _b
    _COMPLEMENT[_a + 32] = _b  # lowercase input (upper-cased first anyway)
# Everything else complements to itself (e.g. N -> N), matching typical
# reverseComplement switch-default behaviour.


@dataclass(frozen=True)
class Minimizers:
    """Winnowed minimizers of one sequence: parallel arrays.

    Each record is a *pick run*: a maximal range of window steps
    [first_step, last_step] over which the same (hash, position) k-mer is
    the window minimum. The minimizer set of any substring [p, p+L) is
    exactly the records whose run intersects the substring's own step
    range [p+w-1, p+L-k] -- the property the fastANI mapping kernel
    relies on for exact window sketches.
    """

    hashes: np.ndarray  # uint64
    positions: np.ndarray  # int64, k-mer start offsets
    strands: np.ndarray  # int8, +1 fwd, -1 rev
    first_steps: np.ndarray  # int64, first window step of the pick run
    last_steps: np.ndarray  # int64, last window step of the pick run

    @property
    def count(self) -> int:
        return int(self.hashes.size)


def _hash_windows(seq: np.ndarray, k: int, chunk: int = 1 << 20) -> np.ndarray:
    """murmur64 of every k-length window of a uint8 byte array."""
    n_win = seq.size - k + 1
    if n_win <= 0:
        return np.empty(0, np.uint64)
    out = np.empty(n_win, dtype=np.uint64)
    for start in range(0, n_win, chunk):
        stop = min(start + chunk, n_win)
        idx = np.arange(start, stop)[:, None] + np.arange(k)[None, :]
        out[start:stop] = murmur64_numpy(seq[idx])
    return out


def canonical_hashes(
    seq_bytes: bytes | np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-position (canonical_hash, strand, valid) for every k-mer window.

    valid is False where the forward and reverse-complement hashes collide
    (strand-symmetric k-mers are skipped by MashMap's sketcher).
    """
    seq = (
        np.frombuffer(seq_bytes, dtype=np.uint8)
        if isinstance(seq_bytes, (bytes, bytearray))
        else np.asarray(seq_bytes, dtype=np.uint8)
    )
    # Uppercase in-place copy (fastANI's makeUpperCase)
    lower = (seq >= ord("a")) & (seq <= ord("z"))
    if lower.any():
        seq = np.where(lower, seq - 32, seq).astype(np.uint8)
    fwd = _hash_windows(seq, k)
    rc_seq = _COMPLEMENT[seq][::-1]
    rc_hashes = _hash_windows(np.ascontiguousarray(rc_seq), k)
    bwd = rc_hashes[::-1]  # bwd[i] = hash of revcomp(seq[i:i+k])
    valid = fwd != bwd
    canonical = np.minimum(fwd, bwd)
    strand = np.where(fwd < bwd, np.int8(1), np.int8(-1))
    return canonical, strand, valid


def window_minimizers(
    seq_bytes: bytes | np.ndarray, k: int, w: int
) -> Minimizers:
    """MashMap-style winnowed minimizers of one sequence.

    Returns records in position order with consecutive duplicates removed,
    i.e. the content of MashMap's ``minimizerIndex`` for the sequence.
    Dispatches to the native monotonic-deque sweep when available
    (bit-identical; parity fuzzed in tests/test_fastani.py), with
    ``window_minimizers_numpy`` as the oracle path.
    """
    from pyani_plus_tpu_torch.native import fastani_winnow_native

    arrays = fastani_winnow_native(seq_bytes, k, w)
    if arrays is not None:
        hashes, positions, strands, first_steps, last_steps = arrays
        return Minimizers(
            hashes=hashes,
            positions=positions,
            strands=strands,
            first_steps=first_steps,
            last_steps=last_steps,
        )
    return window_minimizers_numpy(seq_bytes, k, w)


def window_minimizers_numpy(
    seq_bytes: bytes | np.ndarray, k: int, w: int
) -> Minimizers:
    """Numpy oracle for :func:`window_minimizers` (kept for parity tests)."""
    canonical, strand, valid = canonical_hashes(seq_bytes, k)
    n = canonical.size
    empty = Minimizers(
        np.empty(0, np.uint64),
        np.empty(0, np.int64),
        np.empty(0, np.int8),
        np.empty(0, np.int64),
        np.empty(0, np.int64),
    )
    if n < w:
        # MashMap only records once step i >= w-1; shorter sequences have
        # no full windows.
        return empty

    # Mask invalid positions with +inf-like sentinel for the window minimum.
    SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
    masked = np.where(valid, canonical, SENTINEL)

    # For each recording step i in [w-1, n): the window is positions
    # (i-w, i]. Chosen = rightmost position of the minimum masked hash
    # (matches the deque pop-while >= semantics). Recording only happens
    # at *valid* i (current k-mer not strand-symmetric).
    from numpy.lib.stride_tricks import sliding_window_view

    chosen_pos = np.empty(n - w + 1, dtype=np.int64)
    chunk = 1 << 18
    for start in range(0, n - w + 1, chunk):
        stop = min(start + chunk, n - w + 1)
        view = sliding_window_view(masked[start : stop + w - 1], w)
        mins = view.min(axis=1)
        # rightmost occurrence of the min: flip, argmax of equality, unflip
        eq = view == mins[:, None]
        rev_first = eq[:, ::-1].argmax(axis=1)
        chosen_pos[start:stop] = start + np.arange(stop - start) + (w - 1) - rev_first
    record_at = np.nonzero(valid[w - 1 :])[0] + (w - 1)
    if record_at.size == 0:
        return empty
    picks = chosen_pos[record_at - (w - 1)]
    # Group consecutive (over valid steps) identical picks into runs
    starts = np.empty(picks.size, dtype=bool)
    starts[0] = True
    starts[1:] = picks[1:] != picks[:-1]
    run_idx = np.nonzero(starts)[0]
    run_pick = picks[run_idx]
    first_steps = record_at[run_idx]
    last_idx = np.empty(run_idx.size, dtype=np.int64)
    last_idx[:-1] = run_idx[1:] - 1
    last_idx[-1] = picks.size - 1
    last_steps = record_at[last_idx]
    return Minimizers(
        hashes=canonical[run_pick],
        positions=run_pick,
        strands=strand[run_pick],
        first_steps=first_steps,
        last_steps=last_steps,
    )
