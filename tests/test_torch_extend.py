"""The port's batched free-end extension against the JAX package.

The plain PyTorch version (``batch_extend_reference``) must equal, as
exact tuples, both the Pallas kernel (interpret mode on the CPU, as the
JAX package's own tests run it) and the native host oracle
``band_dp_native``. On a card, the CUDA kernel must equal the plain
version (``gpu`` marker; skipped without CUDA). The Pallas kernel is
imported inside its test, so that the ``gpu`` test also runs where JAX
is not installed: ``python -m pytest tests/test_torch_extend.py -m gpu``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pyani_plus_tpu.genomes import encode_sequence
from pyani_plus_tpu.native import band_dp_native
from pyani_plus_tpu.ops.extend import EXTEND, MATCH, MISMATCH, OPEN
from pyani_plus_tpu_torch.ops import _build
from pyani_plus_tpu_torch.ops import extend as ext

IUPAC = np.frombuffer(b"ACGTNRYSWKMBDHV", dtype=np.uint8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Row-serial small-tensor work: intra-op threads only add overhead."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _native(a: np.ndarray, b: np.ndarray) -> tuple[int, ...]:
    i, j, _score, err, nid, gap = band_dp_native(
        a, b, 60, True, MATCH, MISMATCH, OPEN, EXTEND, 600
    )
    return i, j, err, nid, gap


def _fuzz_tasks(seed: int, count: int, max_len: int) -> list[tuple]:
    """tests/test_dp.py's extension fuzz set: codes 0-4 in a, homology
    with 10% substitutions in 60% of the tasks, uneven lengths."""
    rng = np.random.default_rng(seed)
    tasks = []
    for _ in range(count):
        m = int(rng.integers(60, max_len))
        n = int(rng.integers(60, max_len))
        a = rng.integers(0, 5, m).astype(np.uint8)
        b = rng.integers(0, 4, n).astype(np.uint8)
        if rng.random() < 0.6:
            span = min(m, n)
            b[:span] = a[:span] % 4
            mut = rng.random(span) < 0.1
            b[:span][mut] = (b[:span][mut] + 1) % 4
        tasks.append((a, b))
    return tasks


def _iupac_tasks(seed: int, count: int) -> list[tuple]:
    """Homologous tails salted with N runs and IUPAC letters (codes >= 4:
    never a match, but equal letters are not a non-identity), plus
    short indels so that the gap states carry the best path."""
    rng = np.random.default_rng(seed)
    tasks = []
    for _ in range(count):
        m = int(rng.integers(150, 700))
        a = encode_sequence(IUPAC[rng.integers(0, 4, m)].tobytes())
        b = a.copy()
        mut = rng.random(m) < 0.08
        b[mut] = encode_sequence(IUPAC[rng.integers(0, 15, int(mut.sum()))].tobytes())
        start = int(rng.integers(10, m // 2))
        a[start : start + 25] = encode_sequence(b"N" * 25)
        b[start + 5 : start + 30] = encode_sequence(b"N" * 25)
        cut = int(rng.integers(m // 2, m - 20))
        b = np.concatenate([b[:cut], b[cut + int(rng.integers(1, 5)) :]])
        if rng.random() < 0.5:
            ins = encode_sequence(IUPAC[rng.integers(0, 4, 3)].tobytes())
            b = np.concatenate([b[:40], ins, b[40:]])
        tasks.append((a, b))
    return tasks


# (label, tasks): the fuzz set at a smaller count, IUPAC/N salted tails,
# and hand-made edges (all-N tails, a single row, a tail much longer on
# one side, identical tails that run to their ends)
_EDGES = [
    (encode_sequence(b"N" * 200), encode_sequence(b"N" * 200)),
    (encode_sequence(b"A"), encode_sequence(b"ACGT" * 30)),
    (encode_sequence(b"ACGT" * 30), encode_sequence(b"A")),
    (encode_sequence(b"ACGTTGCA" * 40), encode_sequence(b"ACGTTGCA" * 40)),
    (encode_sequence(b"RYKM" * 40), encode_sequence(b"RYKM" * 40)),
]
CASES = {
    "fuzz": lambda: _fuzz_tasks(41, 10, 900),
    "iupac": lambda: _iupac_tasks(5, 6),
    "edges": lambda: list(_EDGES),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_and_native(case: str) -> None:
    from pyani_plus_tpu.ops.extend_pallas import batch_extend_pallas

    tasks = CASES[case]()
    got = ext.batch_extend_reference(tasks)
    pallas = batch_extend_pallas(tasks, stop_rows=600, interpret=True)
    for idx, (a, b) in enumerate(tasks):
        assert tuple(got[idx]) == _native(a, b), (case, idx)
        assert tuple(got[idx]) == tuple(pallas[idx]), (case, idx)


def test_reference_long_task_matches_native() -> None:
    """A task past the Pallas kernel's largest row bucket (10,240 rows)
    runs as one task, exact against the native oracle."""
    rng = np.random.default_rng(7)
    m = 10_400
    a = rng.integers(0, 4, m).astype(np.uint8)
    b = a.copy()
    mut = rng.random(m) < 0.04
    b[mut] = (b[mut] + 1) % 4
    b[5000:5040] = 4
    short = _fuzz_tasks(3, 2, 400)
    tasks = [(a, b), *short]
    got = ext.batch_extend_reference(tasks)
    assert got[0][0] > 10_240  # the extension really ran that far
    for idx, (x, y) in enumerate(tasks):
        assert tuple(got[idx]) == _native(x, y), idx


def test_batch_extend_dispatch_cpu_and_errors() -> None:
    tasks = _fuzz_tasks(11, 3, 300)
    before = ext.LAUNCHES
    assert ext.batch_extend(tasks, "cpu") == ext.batch_extend_reference(tasks)
    assert ext.LAUNCHES == before  # the plain version launches nothing
    assert ext.batch_extend([], "cpu") == []
    with pytest.raises(ValueError, match="no extension path"):
        ext.batch_extend(tasks, "meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ext.batch_extend_cuda(tasks, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        ext.extend_cuda(*ext.pack_tasks(tasks))


def test_pack_tasks_layout() -> None:
    tasks = [(np.arange(3, dtype=np.uint8), np.arange(5, dtype=np.uint8)),
             (np.arange(4, dtype=np.uint8), np.arange(2, dtype=np.uint8))]
    a_all, b_all, a_off, b_off, m, n = ext.pack_tasks(tasks)
    assert a_off.tolist() == [0, 3] and b_off.tolist() == [0, 5]
    assert m.tolist() == [3, 4] and n.tolist() == [5, 2]
    assert m.dtype == torch.int32 and a_off.dtype == torch.int64
    assert a_all[3:7].tolist() == [0, 1, 2, 3]
    assert b_all[5:7].tolist() == [0, 1]


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path) -> None:
    """A failed nvcc run raises with its own output; nothing is loaded."""
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    script.chmod(0o755)
    monkeypatch.setattr(_build.backend, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build._compile(_build.CSRC_DIR / "extend.cu", tmp_path / "build" / "x.so")
    assert not list((tmp_path / "build").iterdir())
    monkeypatch.setattr(_build.backend, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._compile(_build.CSRC_DIR / "extend.cu", tmp_path / "build" / "x.so")


@pytest.mark.gpu
def test_cuda_kernel_matches_reference() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    tasks = _fuzz_tasks(41, 20, 1100) + _iupac_tasks(5, 6) + list(_EDGES)
    m = 12_000
    a = rng.integers(0, 4, m).astype(np.uint8)
    b = a.copy()
    mut = rng.random(m) < 0.05
    b[mut] = (b[mut] + 1) % 4
    tasks.append((a, b))
    got = ext.batch_extend_cuda(tasks)
    torch.cuda.synchronize()
    assert got == ext.batch_extend_reference(tasks)
    assert got == [_native(x, y) for x, y in tasks]
