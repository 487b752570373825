"""ANIm's per-cluster chain and gap fills in one native call.

``methods/anim._chain_and_fill`` hands a cluster to ``chain_and_fill``
(``native/band.cpp``), which chains it and fills every gap outside the
interpreter lock; its Python body stays as the no-compiler fallback and
the oracle. Here the two are held bit-identical on a seeded fuzz set of
clusters, one case a kind of input the gap fills meet: SNP-only gaps,
indels wide enough to widen the band, anchors swallowed by the previous
one's coverage (dropped), gaps empty on one side, N and IUPAC codes,
single anchors, ties in the chain DP and its maximum, and the clusters
the match finders give. Each case also checks that its inputs reach what
it is named for. The counter ``anim.native_gaps`` counts the gaps the
native call filled, and nothing on the fallback.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from pyani_plus_tpu_torch import native
from pyani_plus_tpu_torch.genomes import encode_sequence
from pyani_plus_tpu_torch.methods import anim
from pyani_plus_tpu_torch.ops import _build, chaining, extend_host, suffix
from pyani_plus_tpu_torch.utils import spans

AMBIGUOUS = encode_sequence(b"NRYSWKMBDHV")
CLUSTERS = 40  # a case's clusters
SCORES = (extend_host.MATCH, extend_host.MISMATCH, extend_host.OPEN, extend_host.EXTEND)


@pytest.fixture(scope="module", autouse=True)
def band_library() -> None:
    if not shutil.which("g++"):
        pytest.skip("no C++ compiler: the native chain and gap fills cannot be built")
    assert _build.load_host_library("band") is not None


def _codes(rng: np.random.Generator, size: int, ambiguous: bool) -> np.ndarray:
    codes = rng.integers(0, 4, size).astype(np.uint8)
    if ambiguous:
        where = rng.random(size) < 0.15
        codes[where] = rng.choice(AMBIGUOUS, int(where.sum()))
    return codes


def _gap(rng: np.random.Generator, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """The (ref, qry) codes of one gap between consecutive anchors."""
    ambiguous = kind == "ambiguous"
    sizes = (1, 1)
    if kind == "indel" and rng.random() < 0.3:
        # a block that aligns only on the band's edge: 20 columns off the
        # gap's diagonal, so that one column less of band loses it
        block = _codes(rng, int(rng.integers(40, 80)), False)
        return (np.concatenate([_codes(rng, 20, False), block]),
                np.concatenate([block, _codes(rng, 20, False)]))  # fmt: skip
    if kind == "indel" and rng.random() < 0.7:
        side = int(rng.integers(0, 40))
        wider = side + int(rng.integers(1, 90))
        sizes = (side, wider) if rng.random() < 0.5 else (wider, side)
    elif kind == "one_side_empty" and rng.random() < 0.6:
        other = int(rng.integers(1, 30))
        sizes = (0, other) if rng.random() < 0.5 else (other, 0)
    elif ambiguous and rng.random() < 0.5:
        sizes = (int(rng.integers(1, 6)), int(rng.integers(1, 6)))
    return _codes(rng, sizes[0], ambiguous), _codes(rng, sizes[1], ambiguous)


def _diagonal(rng: np.random.Generator, kind: str, anchors: int):
    """Anchors along one diagonal, each copied into both sequences, the
    gaps between them drawn by ``kind``; the anchors in a shuffled order."""
    ambiguous = kind == "ambiguous"
    flank = int(rng.integers(0, 40))
    ref = [_codes(rng, flank, ambiguous)]
    qry = [_codes(rng, int(rng.integers(0, 40)), ambiguous)]
    r, q = flank, qry[0].size
    found = []
    for _ in range(anchors):
        length = int(rng.integers(20, 120))
        anchor = _codes(rng, length, ambiguous)
        ref.append(anchor)
        qry.append(anchor)
        found.append((r, q, length))
        g_r, g_q = _gap(rng, kind)
        ref.append(g_r)
        qry.append(g_q)
        r, q = r + length + g_r.size, q + length + g_q.size
    ref.append(_codes(rng, int(rng.integers(0, 40)), ambiguous))
    qry.append(_codes(rng, int(rng.integers(0, 40)), ambiguous))
    return np.concatenate(ref), np.concatenate(qry), found


def _arrays(found: list[tuple[int, int, int]], rng: np.random.Generator):
    order = rng.permutation(len(found))
    r, q, ln = (np.array([found[i][k] for i in order], dtype=np.int64) for k in range(3))
    return r, q, ln


def _fuzz(kind: str, seed: int):
    """``CLUSTERS`` clusters (ref, qry, r, q, ln) of one kind."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(CLUSTERS):
        if kind == "single":
            ref, qry, found = _diagonal(rng, "snp", 1)
        elif kind == "matches":
            ref = rng.integers(0, 4, 6000).astype(np.uint8)
            qry = ref.copy()
            mut = rng.random(ref.size) < float(rng.uniform(0.005, 0.08))
            qry[mut] = (qry[mut] + 1) % 4
            for pos in sorted(rng.integers(100, 5900, 4), reverse=True):
                qry = np.insert(qry, pos, rng.integers(0, 4, int(rng.integers(1, 25))))
            qry = qry.astype(np.uint8)
            r, q, ln = suffix.maximal_matches(ref, qry, 20)
            out.extend((ref, qry, r[i], q[i], ln[i]) for i in chaining.cluster_matches(r, q, ln))
            continue
        else:
            ref, qry, found = _diagonal(rng, kind, int(rng.integers(2, 30)))
        if kind == "swallowed":
            # anchors that end where an earlier one ends, or inside its
            # coverage on one axis: the trim reaches their length; and
            # anchors that overlap an earlier one's end by a base or two
            # more on one axis than on the other: trimmed, not dropped
            for r0, q0, l0 in list(found):
                skip = int(rng.integers(1, l0))
                found.append((r0 + skip, q0 + skip, l0 - skip))
                found.append((r0 + skip, q0 + l0 + int(rng.integers(0, 5)), l0 - skip))
                over, axis = int(rng.integers(1, 15)), int(rng.integers(-2, 3))
                found.append((r0 + l0 - over + min(axis, 0), q0 + l0 - over - max(axis, 0), 40))
        if kind == "ties":
            # both sequences twice: the chain against the qry's second copy
            # and against the ref's second copy, which no anchor of the
            # other can precede or follow (two chains of equal weight), and
            # exact duplicates (equal r in the sort, equal candidates)
            found = [(r0, q0 + qry.size, l0) for r0, q0, l0 in found] + [
                (r0 + ref.size, q0, l0) for r0, q0, l0 in found
            ]
            half = len(found) // 2
            found += [found[int(i) + k] for i in rng.integers(0, half, 2) for k in (0, half)]
            ref, qry = np.concatenate([ref, ref]), np.concatenate([qry, qry])
        out.append((ref, qry, *_arrays(found, rng)))
    return out


def _python_fill(monkeypatch, cluster):
    """The Python body of ``_chain_and_fill`` and the gaps it filled."""
    gaps = []

    def counted(a, b, band=None):
        gaps.append((a.size, b.size))
        return extend_host.gap_errors(a, b, band)

    with monkeypatch.context() as patch:
        patch.setattr(native, "chain_and_fill_native", lambda *_args: None)
        patch.setattr(anim, "gap_errors", counted)
        return anim._chain_and_fill(*cluster), gaps


def _ties(r, q, ln) -> bool:
    """The chain DP's maximum is reached more than once."""
    order = np.argsort(r, kind="stable")
    best, _prev = native.anchor_chain_dp_native(r[order], q[order], ln[order])
    return int((best == best.max()).sum()) > 1


REACHES = {
    "snp": lambda gaps, _cl: all(a == b == 1 for a, b in gaps) and len(gaps) > 0,
    "indel": lambda gaps, _cl: any(min(a, b) and abs(a - b) + 20 < max(a, b) for a, b in gaps),
    "one_side_empty": lambda gaps, _cl: any((a == 0) != (b == 0) for a, b in gaps),
    "ambiguous": lambda gaps, cl: bool((cl[0] >= 4).any() and (cl[1] >= 4).any()) and len(gaps) > 0,
    "single": lambda gaps, cl: cl[2].size == 1 and not gaps,
    "swallowed": lambda gaps, cl: len(anim._consistent_chain(*cl[2:])) - 1 > len(gaps),
    "ties": lambda _gaps, cl: _ties(*cl[2:]),
    "matches": lambda gaps, _cl: len(gaps) > 0,
}


@pytest.mark.parametrize("kind", sorted(REACHES))
def test_native_chain_and_fill_is_the_python_body(kind, monkeypatch) -> None:
    reached = 0
    for cluster in _fuzz(kind, seed=1900 + sorted(REACHES).index(kind)):
        expected, gaps = _python_fill(monkeypatch, cluster)
        fill, filled = native.chain_and_fill_native(*cluster, *SCORES)
        assert fill == expected and all(type(v) is int for v in fill)
        assert filled == len(gaps)
        assert anim._chain_and_fill(*cluster) == expected
        reached += bool(REACHES[kind](gaps, cluster))
    # the inputs reach what the case is named for (all of them for the
    # kinds that hold by construction)
    assert reached == CLUSTERS if kind in ("snp", "single", "ambiguous") else reached > 0


def test_python_body_on_numpy_alone_agrees(monkeypatch) -> None:
    """Without any native library (the path taken without a compiler), the
    Python body's numpy chain and band DPs give the native call's fills."""
    clusters = [c for kind in ("indel", "swallowed", "ties") for c in _fuzz(kind, 1950)[:6]]
    native_fills = [native.chain_and_fill_native(*c, *SCORES)[0] for c in clusters]
    monkeypatch.setattr(_build, "_LIBS", {"host:band": None})
    assert native.chain_and_fill_native(*clusters[0], *SCORES) is None
    assert native.anchor_chain_dp_native(*clusters[0][2:]) is None
    assert [anim._chain_and_fill(*c) for c in clusters] == native_fills


def test_a_cluster_without_anchors_has_no_chain() -> None:
    empty = np.zeros(0, np.int64)
    codes = np.zeros(10, np.uint8)
    assert native.chain_and_fill_native(codes, codes, empty, empty, empty, *SCORES) == (None, 0)
    assert anim._chain_and_fill(codes, codes, empty, empty, empty) is None


def _strains_pair() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(1960)
    ref = rng.integers(0, 4, 40_000).astype(np.uint8)
    qry = ref.copy()
    mut = rng.random(ref.size) < 0.005
    qry[mut] = (qry[mut] + 1) % 4
    qry = np.insert(qry, 20_000, rng.integers(0, 4, 12)).astype(np.uint8)
    return ref, qry


@pytest.mark.parametrize("route", ["native", "fallback"])
def test_native_gaps_counts_the_gaps_filled(route, monkeypatch) -> None:
    """With the recorder on, ``anim.native_gaps`` grows by the gaps the
    Python body would fill (counted there by its ``gap_errors`` calls);
    on the fallback it stays 0, and the alignments are the same."""
    ref, qry = _strains_pair()
    calls = []
    with monkeypatch.context() as patch:
        patch.setattr(native, "chain_and_fill_native", lambda *_args: None)
        patch.setattr(anim, "gap_errors", lambda a, b: calls.append(1) or extend_host.gap_errors(a, b))
        expected = anim.align_sequences(ref, qry)
    assert len(calls) > 100
    if route == "fallback":
        monkeypatch.setattr(native, "chain_and_fill_native", lambda *_args: None)
    spans.reset()
    with spans.recording():
        blocks = anim.align_sequences(ref, qry)
    assert blocks == expected
    counted = spans.counters().get("anim.native_gaps", 0)
    assert counted == (len(calls) if route == "native" else 0)
    spans.reset()
