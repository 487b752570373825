"""The port's batched Smith-Waterman against the JAX package.

The plain PyTorch version (``batch_sw_best_reference``) must equal, as
exact ``(score, best_i, best_j)`` tuples: the Pallas kernel on the score
(interpret mode on the CPU at its small test geometry, as the JAX
package's own tests run it), ``dp_jax.batch_local_align_best`` on all
three, and the native oracle (host score kernel and host stats DP). On a
card, the CUDA kernel must equal the plain version (``gpu`` marker;
skipped without CUDA). JAX modules are imported inside the CPU tests, so
that ``python -m pytest tests/test_torch_sw.py -m gpu`` also runs where
JAX is not installed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pyani_plus_tpu.genomes import encode_sequence
from pyani_plus_tpu_torch.ops import _build
from pyani_plus_tpu_torch.ops import sw

IUPAC = np.frombuffer(b"ACGTNRYSWKMBDHV", dtype=np.uint8)
M_COLS, N_COLS = 128, 256  # the Pallas kernel's interpret-mode geometry


def _pallas_shapes(seed: int, count: int) -> list[tuple]:
    """tests/test_anib.py's Pallas SW set: m <= 128, n <= 256, N codes
    in two of three tasks, a mutated copy in every fourth."""
    rng = np.random.default_rng(seed)
    tasks = []
    for trial in range(count):
        m = int(rng.integers(1, M_COLS + 1))
        n = int(rng.integers(1, N_COLS + 1))
        hi = 5 if trial % 3 else 4
        q = rng.integers(0, hi, m).astype(np.uint8)
        s = rng.integers(0, hi, n).astype(np.uint8)
        if trial % 4 == 0 and n > m:
            s[:m] = q
            mut = rng.random(m) < 0.2
            s[:m][mut] = (s[:m][mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        tasks.append((q, s))
    return tasks


def _trim_shapes(seed: int, count: int) -> list[tuple]:
    """tests/test_dp.py's trim-equivalence set: planted homology in 70%."""
    rng = np.random.default_rng(seed)
    tasks = []
    for _ in range(count):
        m = int(rng.integers(20, 90))
        n = int(rng.integers(30, 140))
        q = rng.integers(0, 5, m).astype(np.uint8)
        s = rng.integers(0, 5, n).astype(np.uint8)
        if rng.random() < 0.7:
            ln = min(m, n) // 2
            s[:ln] = q[:ln]
        tasks.append((q, s))
    return tasks


def _iupac_shapes(seed: int, count: int) -> list[tuple]:
    """Homologous pairs salted with IUPAC letters, padding codes (5) and
    N runs, with short indels so that the gap states carry the best."""
    rng = np.random.default_rng(seed)
    tasks = []
    for _ in range(count):
        m = int(rng.integers(60, M_COLS + 1))
        q = encode_sequence(IUPAC[rng.integers(0, 4, m)].tobytes())
        s = q.copy()
        mut = rng.random(m) < 0.08
        s[mut] = encode_sequence(IUPAC[rng.integers(0, 15, int(mut.sum()))].tobytes())
        start = int(rng.integers(5, m // 2))
        q[start : start + 20] = encode_sequence(b"N" * 20)
        s[start + 3 : start + 23] = encode_sequence(b"N" * 20)
        s[rng.random(m) < 0.03] = 5
        cut = int(rng.integers(m // 2, m - 5))
        s = np.concatenate([s[:cut], s[cut + int(rng.integers(1, 4)) :]])
        flank = rng.integers(0, 4, int(rng.integers(0, N_COLS - s.size))).astype(np.uint8)
        tasks.append((q, np.concatenate([flank, s])))
    return tasks


# no positive cell (all N, all padding, letters that never meet), one
# row, one column, equal maxima in two places (the first one wins)
_EDGES = [
    (encode_sequence(b"N" * 40), encode_sequence(b"ACGT" * 20)),
    (np.full(30, 5, np.uint8), np.full(50, 5, np.uint8)),
    (encode_sequence(b"A" * 50), encode_sequence(b"C" * 90)),
    (encode_sequence(b"G"), encode_sequence(b"ACGTACGT")),
    (encode_sequence(b"ACGTTGCA"), encode_sequence(b"T")),
    (encode_sequence(b"ACGTTGCA"), encode_sequence(b"CC" + b"ACGTTGCA" + b"CC" + b"ACGTTGCA")),
    (encode_sequence(b"ACGTACGT"), encode_sequence(b"ACGTACGTACGT")),
]
CASES = {
    "pallas": lambda: _pallas_shapes(5, 24),
    "trim": lambda: _trim_shapes(7, 24),
    "iupac": lambda: _iupac_shapes(11, 8),
    "edges": lambda: list(_EDGES),
}


def _padded(tasks: list[tuple], m: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    qb = np.full((len(tasks), m), sw.PAD_CODE, np.uint8)
    sb = np.full((len(tasks), n), sw.PAD_CODE, np.uint8)
    for row, (q, s) in enumerate(tasks):
        qb[row, : q.size] = q
        sb[row, : s.size] = s
    return qb, sb


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_dp_jax_and_native(case: str) -> None:
    from pyani_plus_tpu.ops import sw_pallas
    from pyani_plus_tpu.ops.dp_jax import batch_local_align_best

    tasks = CASES[case]()
    got = sw.batch_sw_best_reference(tasks)
    assert got == sw.batch_sw_best_host(tasks)
    qb, sb = _padded(tasks, M_COLS, N_COLS)
    best = np.asarray(batch_local_align_best(qb, sb))
    assert got == [tuple(int(v) for v in row) for row in best]
    scores = np.asarray(
        sw_pallas.batch_sw_scores_pallas(
            qb, sb, interpret=True, m_cols=M_COLS, n_cols=N_COLS
        )
    )
    assert [row[0] for row in got] == [int(v) for v in scores]
    if case == "edges":
        assert got[:3] == [(0, 0, 0)] * 3
        assert got[5][1:] == (8, 10)  # the first of two equal maxima


def test_reference_wide_windows_and_long_fragments() -> None:
    """Windows past the JAX package's 2,048-lane Pallas geometry and
    fragments past 1,024 rows, exact against the native oracle; each
    window ends with a mutated copy of its fragment."""
    rng = np.random.default_rng(13)
    tasks = []
    for m, n in ((200, 2049), (60, 4100), (1100, 1200), (40, 90)):
        q = rng.integers(0, 4, m).astype(np.uint8)
        s = rng.integers(0, 4, n).astype(np.uint8)
        s[n - m :] = q
        mut = rng.random(n) < 0.05
        s[mut] = (s[mut] + 1) % 4
        tasks.append((q, s))
    got = sw.batch_sw_best_reference(tasks)
    assert got == sw.batch_sw_best_host(tasks)
    assert got[0][2] > 2048 and got[1][2] > 4000
    assert got[2][1] > 1024


def test_reference_chunks_do_not_change_results() -> None:
    """The plain version pads chunks of similar windows; many tasks of
    mixed widths (several chunks) give the same rows one by one."""
    rng = np.random.default_rng(17)
    tasks = _pallas_shapes(19, 40) + _trim_shapes(23, 30)
    order = rng.permutation(len(tasks))
    tasks = [tasks[i] for i in order]
    whole = sw.batch_sw_best_reference(tasks)
    assert whole == [sw.batch_sw_best_reference([t])[0] for t in tasks]


def test_batch_sw_best_dispatch_cpu_and_errors() -> None:
    tasks = _trim_shapes(3, 4)
    before = (sw.LAUNCHES, sw.TASKS)
    assert sw.batch_sw_best(tasks, "cpu") == sw.batch_sw_best_reference(tasks)
    assert (sw.LAUNCHES, sw.TASKS) == before  # the plain version launches nothing
    assert sw.batch_sw_best([], "cpu") == []
    with pytest.raises(ValueError, match="no Smith-Waterman path"):
        sw.batch_sw_best(tasks, "meta")
    with pytest.raises(ValueError, match="CUDA device"):
        sw.batch_sw_best_cuda(tasks, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        sw.sw_cuda(*sw.pack_tasks(tasks))
    assert (sw.LAUNCHES, sw.TASKS) == before


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path) -> None:
    """A failed nvcc run on sw.cu raises with its own output; nothing is
    left behind and nothing is loaded."""
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\necho 'sw.cu: error: no DPX here' >&2\nexit 1\n")
    script.chmod(0o755)
    monkeypatch.setattr(_build.backend, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / "build" / f"lib{name}.so")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="no DPX here"):
        _build.load_library("sw")
    assert not list((tmp_path / "build").iterdir())
    assert "sw" not in _build._LIBS


@pytest.mark.gpu
def test_cuda_kernel_matches_reference() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(29)
    tasks = [t for make in CASES.values() for t in make()]
    # the last four lie at either side of the width rule: packed 16-bit
    # lanes up to min(m, n) = 16,360, 32-bit words from 16,361
    for m, n in ((1020, 2049), (1020, 8192), (300, 32769), (1500, 1700),
                 (16360, 16500), (16361, 16400), (16400, 18000), (16900, 16950)):  # fmt: skip
        q = rng.integers(0, 4, m).astype(np.uint8)
        s = rng.integers(0, 4, n).astype(np.uint8)
        at = int(rng.integers(0, n - m))
        s[at : at + m] = q
        mut = rng.random(n) < (0.0 if m == 16360 else 0.1)  # a perfect copy at the edge
        s[mut] = (s[mut] + 1) % 4
        tasks.append((q, s))
    assert [sw.uses_packed_lanes(q.size, s.size) for q, s in tasks[-4:]] == [True] + [False] * 3
    before = sw.LAUNCHES
    got = sw.batch_sw_best_cuda(tasks)
    torch.cuda.synchronize()
    assert sw.LAUNCHES == before + 1
    want = sw.batch_sw_best_reference(tasks)
    assert got == want
    assert got == sw.batch_sw_best_host(tasks)
    assert got[-4][0] == 2 * 16360


# --- csrc/sw.cu's row, transcribed ----------------------------------------
#
# The kernel runs only on a card. Its arithmetic is held here on the CPU by
# a numpy transcription of one task as a warp computes it: 32 lanes, each
# with PACKED_COLS (or WIDE_COLS) window columns of a stripe, the window
# profile, the diagonal taken from the left neighbour, F with its fill,
# the clamped G, the running maxima of G + ge*c kept apart for even and
# odd columns as the packed registers keep them, the 32-bit scan across
# lanes seeded with the rebased carry of the stripes to the left, the
# clamp of what a lane is handed, the first maximum of each lane's cells
# and the merge of lanes and stripes. On the packed path every per-cell
# value is an int16 array, and numpy's int16 arithmetic wraps around, so
# a value that does not fit shows as a wrong result.

BLASTN = (sw.REWARD, sw.PENALTY, sw.GAP_OPEN, sw.GAP_EXTEND)
# blastn's scoring times 200: the width rule turns at min(m, n) = 58, so
# tasks at both sides of it stay small enough for a row loop in Python
SCALED = tuple(200 * v for v in BLASTN)


def _kernel_task(q: np.ndarray, s: np.ndarray, *, packed: bool,
                 scoring: tuple = BLASTN) -> tuple[int, int, int]:
    reward, penalty, go, ge = scoring
    cols = sw.PACKED_COLS if packed else sw.WIDE_COLS
    dt = np.int16 if packed else np.int32
    stripe = 32 * cols
    m, n = q.size, s.size
    lane0 = (np.arange(32) * cols).astype(np.int32)  # a lane's first column in the stripe
    gej = (ge * np.arange(cols)).astype(dt)
    nk = (-go - ge * np.arange(cols)).astype(dt)
    fill = dt(-(go + ge)) if packed else dt(sw.NEG)
    floor = np.iinfo(np.int16).min if packed else int(sw.NEG)
    edge = np.zeros((m, 2), np.int32)  # (H, E carry) at the stripe's right end
    best = (0, 0, 0)
    for j0 in range(0, n, stripe):
        first, last = j0 == 0, j0 + stripe >= n
        codes = np.full(stripe, 255, np.int32)
        codes[: min(stripe, n - j0)] = s[j0 : j0 + stripe]
        codes = codes.reshape(32, cols)
        profile = np.where(codes[None] == np.arange(4)[:, None, None], reward, penalty)
        profile = np.concatenate([profile, np.full((1, 32, cols), penalty)]).astype(dt)
        h = np.zeros((32, cols), dt)
        f = np.full((32, cols), fill, dt)
        edge_h_prev = 0
        mine = np.zeros((32, 3), np.int32)
        for i in range(1, m + 1):
            sub = profile[min(int(q[i - 1]), 4)]
            edge_h, carry = (0, int(sw.NEG)) if first else (int(edge[i - 1, 0]), int(edge[i - 1, 1]))
            carry -= ge * stripe  # rebased to this stripe's first column
            left = np.roll(h[:, -1], 1)
            left[0] = edge_h_prev
            diag = np.concatenate([left[:, None], h[:, :-1]], axis=1)
            f = np.maximum(h + dt(-(go + ge)), f + dt(-ge))  # no clamp: a wrap would show
            g = np.maximum(np.maximum(diag + sub, f), dt(0))
            # inclusive running maxima, even columns and odd columns apart
            run = np.maximum.accumulate((g + gej).reshape(32, cols // 2, 2), axis=1)
            total = run[:, -1].max(axis=1).astype(np.int32) + ge * lane0
            total[0] = max(total[0], carry)
            incl = np.maximum.accumulate(total)
            handed = np.concatenate([[carry], incl[:-1]]).astype(np.int32) - ge * lane0
            if packed:  # at or below 0 it cannot lift a cell
                handed = np.maximum(handed, 0)
            handed = handed.astype(dt)[:, None]
            prev = np.concatenate([np.full((32, 1, 2), floor, dt), run[:, :-1]], axis=1)
            x_even = np.maximum(np.maximum(prev[:, :, 0], prev[:, :, 1]), handed)
            x_odd = np.maximum(np.maximum(run[:, :, 0], prev[:, :, 1]), handed)
            x = np.stack([x_even, x_odd], axis=2).reshape(32, cols)
            h = np.maximum(g, x + nk)
            row_j = np.argmax(h, axis=1)  # the first maximum of the lane's cells
            row_max = h[np.arange(32), row_j].astype(np.int32)
            better = row_max > mine[:, 0]
            mine[better, 0] = row_max[better]
            mine[better, 1] = i
            mine[better, 2] = (j0 + lane0 + row_j + 1)[better]
            if not last:
                edge[i - 1] = (h[31, -1], incl[31])
            edge_h_prev = edge_h
        for score, bi, bj in mine.tolist():
            if (-score, bi, bj) < (-best[0], best[1], best[2]):
                best = (score, bi, bj)
    return best


def _rule(m: int, n: int, scoring: tuple) -> bool:
    """ops/sw.uses_packed_lanes for any scoring (the kernel and the
    wrapper know blastn's only)."""
    return scoring[0] * min(m, n) + scoring[3] * (sw.PACKED_COLS - 1) <= sw.INT16_MAX


def _kernel(tasks: list[tuple], scoring: tuple = BLASTN, *, packed: bool | None = None):
    """Each task on the path the width rule gives it (or on `packed`)."""
    out = []
    for q, s in tasks:
        if not q.size or not s.size:
            out.append((0, 0, 0))
            continue
        rule = _rule(q.size, s.size, scoring)
        out.append(_kernel_task(q, s, packed=rule if packed is None else packed, scoring=scoring))
    return out


def _native(tasks: list[tuple], scoring: tuple) -> list[tuple]:
    from pyani_plus_tpu_torch.native import local_align_score_native, local_align_stats_native

    out = []
    for task in tasks:
        score = local_align_score_native(*task, *scoring)
        stats = local_align_stats_native(*task, *scoring)
        assert score is not None and stats is not None
        out.append((score, stats[7], stats[9]) if stats else (score, 0, 0))
    return out


@pytest.mark.parametrize("path", ["packed", "wide"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_transcription_matches_plain_and_native(case: str, path: str) -> None:
    from pyani_plus_tpu.ops.dp_jax import batch_local_align_best

    tasks = CASES[case]()
    got = _kernel(tasks, packed=path == "packed")
    assert got == sw.batch_sw_best_reference(tasks)
    assert got == sw.batch_sw_best_host(tasks)
    best = np.asarray(batch_local_align_best(*_padded(tasks, M_COLS, N_COLS)))
    assert got == [tuple(int(v) for v in row) for row in best]


@pytest.mark.parametrize("path", ["packed", "wide"])
@pytest.mark.parametrize(
    ("m", "n"), [(90, 513), (70, 1025), (130, 2049), (24, 32769), (1100, 300), (17, 33000)]
)
def test_kernel_transcription_across_stripes(m: int, n: int, path: str) -> None:
    """Windows past one, two and 64 packed stripes (and as many more of
    the 32-bit path's): the alignment sits at the window's far end, in
    two halves around a deletion in the window so that an E run carries
    the score, with N runs and padding codes salted in."""
    rng = np.random.default_rng(m * 100003 + n)
    q = rng.integers(0, 4, m).astype(np.uint8)
    s = rng.integers(0, 4, n).astype(np.uint8)
    core = np.concatenate([q[: m // 2], rng.integers(0, 4, 3).astype(np.uint8), q[m // 2 :]])
    core = core[: n - 1]
    s[n - core.size :] = core
    s[rng.random(n) < 0.01] = 5
    q[m // 3 : m // 3 + 4] = 4
    tasks = [(q, s), (q, s[: n - 7]), (s[-60:], q)]
    got = _kernel(tasks, packed=path == "packed")
    assert got == sw.batch_sw_best_host(tasks)
    assert got == sw.batch_sw_best_reference(tasks)
    assert got[0][0] > 0
    if m >= 60:  # a short fragment finds its equal by chance earlier in a long window
        assert got[0][2] > n - core.size


def test_kernel_transcription_long_gap_across_stripes() -> None:
    """A gap in the window of 700 columns: the E run opened in one stripe
    is what scores in the next, so the rebased carry decides the result;
    and a carry that has sunk below 0 (clamped on the packed path) beside
    it. Scoring with a cheap gap makes the long run worth taking."""
    rng = np.random.default_rng(41)
    cheap = (40, -60, 0, 1)
    q = rng.integers(0, 4, 500).astype(np.uint8)
    gap = np.full(700, 5, np.uint8)
    s = np.concatenate([rng.integers(0, 4, 200).astype(np.uint8), q[:250], gap, q[250:],
                        rng.integers(0, 4, 90).astype(np.uint8)])
    tasks = [(q, s), (q[:250], np.concatenate([q[:125], np.full(6000, 5, np.uint8), q[125:250]]))]
    want = _native(tasks, cheap)
    assert want[0][0] == 40 * 500 - 700  # the run was taken
    assert want[1][0] == 40 * 125  # and here it was not worth it
    assert _rule(500, s.size, cheap)
    assert _kernel(tasks, cheap) == want
    assert _kernel(tasks, cheap, packed=False) == want


@pytest.mark.parametrize("size", [57, 58, 59, 60])
def test_kernel_transcription_at_the_width_rule(size: int) -> None:
    """blastn's scoring times 200 puts the rule's edge at min(m, n) = 58.
    A perfect match of that length that ends in a lane's last column
    reaches the largest value a packed word can be asked to hold; one row
    more and the task takes the 32-bit path. Both give the native DP's
    tuple, with the best cell's row scored through a gap as well."""
    rng = np.random.default_rng(size)
    assert _rule(size, 300, SCALED) == (size <= 58)
    q = rng.integers(0, 4, size).astype(np.uint8)
    tasks = []
    for end in (sw.PACKED_COLS * 5, sw.PACKED_COLS * 32 + 7):  # a lane's last column; stripe 2
        s = (rng.integers(0, 4, end + 40).astype(np.uint8) + 1) % 4
        s[end - size : end] = q
        tasks.append((q, s))
        tasks.append((s, q))  # min(m, n) decides, not the fragment
    gapped = np.concatenate([q[:30], np.array([5], np.uint8), q[30:]])
    tasks.append((q, gapped))
    want = _native(tasks, SCALED)
    assert want[0] == (SCALED[0] * size, size, sw.PACKED_COLS * 5)
    assert _kernel(tasks, SCALED) == want
    if size <= 58:  # the 32-bit path takes any task
        assert _kernel(tasks, SCALED, packed=False) == want


@pytest.mark.parametrize(
    ("m", "n", "packed"),
    [
        (1, 1, True),
        (1020, 1320, True),
        (1020, 32769, True),
        (3000, 3300, True),
        (16360, 16360, True),
        (16360, 1 << 30, True),
        (1 << 30, 16360, True),
        (16361, 16360, True),
        (16361, 16361, False),
        (16361, 1 << 30, False),
        (40000, 20000, False),
    ],
)
def test_uses_packed_lanes_edges(m: int, n: int, packed: bool) -> None:
    """2 * min(m, n) + 2 * 23 <= 32767: the window's length alone never
    sends a task to the 32-bit path."""
    assert sw.uses_packed_lanes(m, n) is packed
    assert sw.uses_packed_lanes(n, m) is packed
    assert _rule(m, n, BLASTN) is packed


def test_width_rule_is_per_task_in_a_mixed_batch() -> None:
    """The kernel gives a warp one task and computes the rule from that
    task's (m, n) as pack_tasks lays them out, so the choice is uniform
    across a warp whatever the batch holds."""
    sizes = [(1020, 1320), (16361, 16400), (40, 32769), (16400, 16360), (16360, 70000), (20000, 16361)]
    tasks = [(np.zeros(m, np.uint8), np.ones(n, np.uint8)) for m, n in sizes]
    _, _, q_off, s_off, m, n = sw.pack_tasks(tasks)
    assert m.dtype == n.dtype == torch.int32 and q_off[-1] == sum(a for a, _ in sizes[:-1])
    choice = [sw.uses_packed_lanes(a, b) for a, b in zip(m.tolist(), n.tolist())]
    assert choice == [True, False, True, True, True, False]


# the 30th match in a lane's last column (and in the one before it)
_LANE_END = 2 * sw.PACKED_COLS - 30


@pytest.mark.parametrize("offset", [0, 1, _LANE_END - 1, _LANE_END])
def test_kernel_transcription_one_column_gaps(offset: int) -> None:
    """One extra window column after 30 matches, the match before it in
    an even or an odd column of a register and in a lane's last column:
    the cell after the gap takes E from its direct neighbour, which the
    packed row reads across the two halves of one register or from the
    register (or the lane) before. And one extra fragment row (F)."""
    rng = np.random.default_rng(offset)
    q = rng.integers(0, 4, 60).astype(np.uint8)
    flank = (q[:offset] + 1) % 4
    extra = np.array([(q[30] + 2) % 4], np.uint8)
    s = np.concatenate([flank, q[:30], extra, q[30:]])
    tasks = [(q, s), (s, q)]
    want = sw.batch_sw_best_host(tasks)
    assert want[0][0] == want[1][0] == 2 * 60 - 7
    assert _kernel(tasks, packed=True) == want
    assert _kernel(tasks, packed=False) == want


def test_kernel_source_constants_match_the_wrapper() -> None:
    """csrc/sw.cu compiles blastn's scoring and its lane geometry in; the
    wrapper's rule and the transcription above read the same numbers."""
    import re

    source = (_build.CSRC_DIR / "sw.cu").read_text()

    def constant(name: str) -> int:
        return int(re.search(rf"constexpr int {name} = (-?\d+);", source).group(1))

    scoring = tuple(constant(n) for n in ("REWARD", "PENALTY", "GAP_OPEN", "GAP_EXTEND"))
    assert scoring == BLASTN
    assert constant("PCOLS") == sw.PACKED_COLS
    assert constant("WCOLS") == sw.WIDE_COLS
    assert "<= 32767" in source and sw.INT16_MAX == 32767
