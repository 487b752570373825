"""The port's batched free-end extension against the JAX package.

The plain PyTorch version (``batch_extend_reference``) must equal, as
exact tuples, both the Pallas kernel (interpret mode on the CPU, as the
JAX package's own tests run it) and the native host oracle
``band_dp_native``. On a card, the CUDA kernel must equal the plain
version (``gpu`` marker; skipped without CUDA). The Pallas kernel is
imported inside its test, so that the ``gpu`` test also runs where JAX
is not installed: ``python -m pytest tests/test_torch_extend.py -m gpu``.

The CUDA kernel cannot run without a card, so what the CPU reaches of it
is held here: the wrapper's packing, launch order, field-width choice
and submit/collect, and ``_kernel_model``, a numpy transcription of the
kernel's row algorithm (two states a column, packed 16-bit payload
fields, the key * 128 + column scan with lane aggregates), against the
native oracle.
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
from pyani_plus_tpu_torch.ops._tasks import Submitted, pack_tasks
from pyani_plus_tpu_torch.ops.extend_host import extend_errors as port_extend_errors
from pyani_plus_tpu_torch.synthetic import extension_fuzz_tasks

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
    "fuzz": lambda: extension_fuzz_tasks(41, 10, 900),
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
    short = extension_fuzz_tasks(3, 2, 400)
    tasks = [(a, b), *short]
    got = ext.batch_extend_reference(tasks)
    assert got[0][0] > 10_240  # the extension really ran that far
    for idx, (x, y) in enumerate(tasks):
        assert tuple(got[idx]) == _native(x, y), idx


def test_batch_extend_dispatch_cpu_and_errors() -> None:
    tasks = extension_fuzz_tasks(11, 3, 300)
    before = ext.LAUNCHES
    assert ext.batch_extend(tasks, "cpu") == ext.batch_extend_reference(tasks)
    assert ext.LAUNCHES == before  # the plain version launches nothing
    assert ext.batch_extend([], "cpu") == []
    with pytest.raises(ValueError, match="no extension path"):
        ext.batch_extend(tasks, "meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ext.extend_cuda(*pack_tasks(tasks, ext.launch_order(tasks)).views())


def test_pack_tasks_layout() -> None:
    """One staging buffer, longest task first; the six views the kernel
    takes point into it."""
    tasks = [(np.arange(3, dtype=np.uint8), np.arange(5, dtype=np.uint8)),
             (np.arange(4, dtype=np.uint8) + 10, np.arange(2, dtype=np.uint8) + 20),
             (np.zeros(0, np.uint8), np.arange(1, dtype=np.uint8) + 30)]
    order = ext.launch_order(tasks)
    assert order.tolist() == [1, 0, 2]
    packed = pack_tasks(tasks, order)
    staging = packed.buf
    assert staging.dtype == torch.uint8 and staging.dim() == 1
    assert staging.numel() == 24 * 3 + (4 + 3 + 0) + (2 + 5 + 1) + 1
    a_all, b_all, a_off, b_off, m, n = packed.views()
    assert a_all.data_ptr() == b_all.data_ptr() == staging.data_ptr() + 72
    assert m.tolist() == [4, 3, 0] and n.tolist() == [2, 5, 1]
    assert a_off.tolist() == [0, 4, 7] and b_off.tolist() == [7, 9, 14]
    assert m.dtype == torch.int32 and a_off.dtype == torch.int64
    assert a_all[0:4].tolist() == [10, 11, 12, 13]
    assert a_all[4:7].tolist() == [0, 1, 2]
    assert b_all[7:9].tolist() == [20, 21]
    assert b_all[9:14].tolist() == [0, 1, 2, 3, 4]
    assert b_all[14:15].tolist() == [30]
    for view in (a_off, b_off, m, n):  # views, not copies: one transfer moves all
        lo, hi = staging.data_ptr(), staging.data_ptr() + staging.numel()
        assert lo <= view.data_ptr() < hi


def test_launch_order_longest_first_and_stable() -> None:
    sizes = [(5, 9), (900, 3), (5, 1), (12_000, 60_000), (900, 7)]
    tasks = [(np.zeros(m, np.uint8), np.zeros(n, np.uint8)) for m, n in sizes]
    assert ext.launch_order(tasks).tolist() == [3, 1, 4, 0, 2]
    # 16-bit payload fields up to m + n = 65,535, 32-bit fields past it
    assert [ext.uses_packed_fields(t) for t in tasks] == [True, True, True, False, True]
    edge = (np.zeros(65_000, np.uint8), np.zeros(535, np.uint8))
    assert ext.uses_packed_fields(edge)
    assert not ext.uses_packed_fields((edge[0], np.zeros(536, np.uint8)))


class _FakeEvent:
    def __init__(self) -> None:
        self.waited = 0

    def synchronize(self) -> None:
        self.waited += 1


def test_collect_restores_the_callers_order() -> None:
    """The kernel writes row p for the task at launch position p; collect
    waits for the batch's own event and hands rows back by task index."""
    order = np.array([2, 0, 3, 1])
    out = torch.tensor([[p, 10 * p, 0, 0, p] for p in range(4)], dtype=torch.int32)
    event = _FakeEvent()
    state = Submitted(out, order, event, keep=(out,))
    got = ext.batch_extend_collect(state)
    assert event.waited == 1 and state.keep == ()
    assert got == [(1, 10, 0, 0, 1), (3, 30, 0, 0, 3), (0, 0, 0, 0, 0), (2, 20, 0, 0, 2)]
    assert all(isinstance(v, int) for row in got for v in row)


def test_submit_collect_on_cpu_is_the_plain_version() -> None:
    tasks = extension_fuzz_tasks(19, 4, 250)
    state = ext.batch_extend_submit(tasks, "cpu")
    assert state.arrived is None and state.order is None
    assert ext.batch_extend_collect(state) == ext.batch_extend_reference(tasks)
    with pytest.raises(ValueError, match="no extension path"):
        ext.batch_extend_submit(tasks, "meta")


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path) -> None:
    """A failed nvcc run raises with its own output; nothing is loaded."""
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    script.chmod(0o755)
    monkeypatch.setattr(_build.backend, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build._compile_cuda(_build.CSRC_DIR / "extend.cu", tmp_path / "build" / "x.so")
    assert not list((tmp_path / "build").iterdir())
    monkeypatch.setattr(_build.backend, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._compile_cuda(_build.CSRC_DIR / "extend.cu", tmp_path / "build" / "x.so")


def _kernel_model(a: np.ndarray, b: np.ndarray, *, packed: bool) -> tuple[int, ...]:  # noqa: PLR0915
    """csrc/extend.cu's row algorithm for one task, in numpy.

    What the kernel does differently from the oracle's recurrences, all
    reproduced here: two states a column (cell = best3(M, D, I), and D,
    which opens from cell); with ``packed``, errors | nonid << 16 and gap
    columns as wrapping 32-bit words; the I state as a prefix maximum of
    key * 128 + column with one aggregate per 4-column lane, the payload
    fetched from the lane that owns the winner; the best cell from
    score * 128 + column.
    """
    band, width, stop_rows = 60, 121, 600
    m, n = a.size, b.size
    neg = -(1 << 22) if packed else -(10**9)
    cols = np.arange(128)
    wrap = (1 << 32) - 1

    def shift(pay, d):  # add d to errors, nonid and gap columns
        if packed:
            return np.stack([(pay[0] + d * 0x10001) & wrap, (pay[1] + d) & wrap, pay[2]])
        return pay + np.asarray(d)

    def subst(pay, sub_ok, same):
        if packed:
            step = np.where(sub_ok, 0, np.where(same, 1, 0x10001))
            return np.stack([(pay[0] + step) & wrap, pay[1], pay[2]])
        return np.stack([pay[0] + ~sub_ok, pay[1] + ~same, pay[2]])

    def b_codes(idx):
        out = np.full(idx.shape, 255, np.int64)
        inside = (idx >= 0) & (idx < n)
        out[inside] = b[idx[inside]]
        return out

    # row 0: the origin at j == 0, horizontal runs to its right; D dead
    j0 = cols - band
    cs = np.full(128, neg, np.int64)
    cs[(cols < width) & (j0 == 0)] = 0
    runs = (cols < width) & (j0 >= 1) & (j0 <= n)
    cs[runs] = OPEN + EXTEND * (j0[runs] - 1)
    cp = np.where(runs, shift(np.zeros((3, 128), np.int64), j0), 0)
    ds = np.full(128, neg, np.int64)
    dp = np.zeros((3, 128), np.int64)
    best = (0, 0, 0)
    best_pay = np.zeros(3, np.int64)
    rows_since = 0
    dead_col = np.zeros((3, 1), np.int64)
    for i in range(1, m + 1):
        ac = int(a[i - 1])
        jbase = i - band
        j = cols + jbase
        bc = b_codes(cols + jbase - 1)
        valid = (cols < width) & (j >= 0) & (j <= n)
        valid1 = valid & (j >= 1)
        sub_ok = bc == (ac if ac < 4 else 256)
        same = bc == ac
        ms = np.where(valid1, cs + np.where(sub_ok, MATCH, MISMATCH), neg)
        mp = subst(cp, sub_ok, same)
        open_s = np.append(cs[1:], neg) + OPEN
        cont_s = np.append(ds[1:], neg) + EXTEND
        take_cont = cont_s >= open_s
        d_s = np.where(take_cont, cont_s, open_s)
        d_s = np.where(valid, d_s, neg)
        up_open = np.concatenate([cp[:, 1:], dead_col], axis=1)
        up_cont = np.concatenate([dp[:, 1:], dead_col], axis=1)
        d_p = shift(np.where(take_cont, up_cont, up_open), 1)
        take_d = d_s > ms
        bs = np.where(take_d, d_s, ms)
        bp = np.where(take_d, d_p, mp)
        v = (bs + OPEN - EXTEND * (cols + 1)) * 128 + cols
        if packed:
            assert v.min() >= -(1 << 31) and v.max() < (1 << 31)
        rel = shift(bp, -cols)
        # one aggregate per lane, an exclusive scan over the lanes, and
        # the winner's payload from the lane that owns it
        agg = v.reshape(32, 4).max(axis=1)
        agg_pay = rel[:, np.arange(32) * 4 + v.reshape(32, 4).argmax(axis=1)]
        before = np.concatenate([[neg * 128], np.maximum.accumulate(agg)[:-1]])
        before_pay = agg_pay[:, (before & 127) >> 2]
        i_s = np.empty(128, np.int64)
        i_p = np.zeros((3, 128), np.int64)
        for lane in range(32):
            run, run_pay = before[lane], before_pay[:, lane]
            for k in range(4 * lane, 4 * lane + 4):
                left, left_pay = run, run_pay
                if v[k] > run:
                    run, run_pay = v[k], rel[:, k]
                key = left >> 7
                i_s[k] = key + EXTEND * k if valid1[k] else neg
                i_p[:, k] = shift(left_pay.reshape(3, 1), k)[:, 0]
        take_i = i_s > bs
        cs = np.where(take_i, i_s, bs)
        cp = np.where(take_i, i_p, bp)
        ds, dp = d_s, d_p
        row_key = int((cs * 128 + cols).max())
        rmax, kmax = row_key >> 7, row_key & 127
        jbest = kmax + jbase
        if rmax > best[2] or (rmax == best[2] and i + jbest > best[0] + best[1]):
            best = (i, jbest, rmax)
            best_pay = cp[:, kmax].copy()
            rows_since = 0
        else:
            rows_since += 1
            if rows_since >= stop_rows:
                break
    if packed:
        en = int(best_pay[0])
        return best[0], best[1], en & 0xFFFF, en >> 16, int(best_pay[1])
    return (best[0], best[1], *(int(x) for x in best_pay))


@pytest.mark.parametrize("packed", [True, False], ids=["fields16", "fields32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_row_algorithm_matches_native(case: str, packed: bool) -> None:
    """csrc/extend.cu's restructured row (see ``_kernel_model``) gives the
    oracle's tuples with 16-bit and with 32-bit payload fields."""
    for idx, (a, b) in enumerate(CASES[case]()):
        assert _kernel_model(a, b, packed=packed) == _native(a, b), (case, idx)


def test_host_oracle_copy_matches_jax_package() -> None:
    from pyani_plus_tpu.ops.extend import extend_errors

    for a, b in extension_fuzz_tasks(23, 6, 500) + list(_EDGES):
        assert port_extend_errors(a, b) == extend_errors(a, b)


@pytest.mark.gpu
def test_cuda_kernel_matches_reference() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    tasks = extension_fuzz_tasks(41, 20, 1100) + _iupac_tasks(5, 6) + list(_EDGES)
    # tests/test_dp.py's oversize case (past 10,240 rows), a 12,000-row
    # task, and one past 65,535 rows + columns (32-bit payload fields)
    for m, n in ((10_304, 400), (10_336, 10_304), (12_000, 12_000), (40_000, 40_000)):
        a = rng.integers(0, 4, m).astype(np.uint8)
        b = a[: min(m, n)].copy()
        mut = rng.random(b.size) < 0.05
        b[mut] = (b[mut] + 1) % 4
        tasks.append((a, b))
    assert not ext.uses_packed_fields(tasks[-1])
    before = ext.LAUNCHES
    got = ext.batch_extend(tasks, "cuda")
    torch.cuda.synchronize()
    assert ext.LAUNCHES == before + 1
    assert got == [_native(x, y) for x, y in tasks]
    small = [t for t in tasks if t[0].size <= 1100]  # the plain version's row loop is slow
    assert ext.batch_extend(small, "cuda") == ext.batch_extend_reference(small)
