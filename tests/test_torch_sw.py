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
    for m, n in ((1020, 2049), (1020, 8192), (300, 32769), (1500, 1700)):
        q = rng.integers(0, 4, m).astype(np.uint8)
        s = rng.integers(0, 4, n).astype(np.uint8)
        at = int(rng.integers(0, n - m))
        s[at : at + m] = q
        mut = rng.random(n) < 0.1
        s[mut] = (s[mut] + 1) % 4
        tasks.append((q, s))
    before = sw.LAUNCHES
    got = sw.batch_sw_best_cuda(tasks)
    torch.cuda.synchronize()
    assert sw.LAUNCHES == before + 1
    assert got == sw.batch_sw_best_reference(tasks)
    assert got == sw.batch_sw_best_host(tasks)
