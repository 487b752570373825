"""The port's alignment DPs against the JAX package: tests/test_dp.py, case
for case.

Each case feeds one seeded input (``pyani_plus_tpu_torch.synthetic``
draws it as the JAX case does) to the JAX function and to its port
counterpart and holds the outputs equal, exact to the integer; where the
JAX case checks against known values or the native oracle, so does this
one. The JAX package's device paths map to the port's CPU dispatch
(``PYANI_TPU_TORCH_DEVICE=cpu``, set by the root ``conftest.py``):

- ``dp_jax.batch_local_align_scores`` / ``batch_local_align_best`` to
  ``ops/sw.batch_sw_best(tasks, "cpu")`` (the plain version) and its
  native oracle ``batch_sw_best_host``;
- ``extend_jax.batch_extend_errors`` and ``extend_pallas.batch_extend_pallas``
  (interpret mode) to ``ops/extend.batch_extend(tasks, "cpu")``;
- ``test_batch_extend_pallas_oversize_falls_back_to_host`` to the port's
  "any length" rule: the port has no bucket ladder and no host route, so
  its dispatch takes the JAX case's four tasks, two longer than the JAX
  package's largest bucket, as they are
  (``test_oversize_tasks_run_through_the_port``).

Not ported: ``test_anim_device_extension_pipeline_parity`` (fixture
genomes) is held on synthetic genomes by
``tests/test_torch_anim.py::test_anim_pair_matches_jax`` (its ``batched``
fixture forces the extension batch) and by
``tests/test_torch_coverage_semantics.py``'s batched case, which compute
the JAX host rows and the port's batched rows on the same genomes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from pyani_plus_tpu.genomes import encode_sequence as jax_encode
from pyani_plus_tpu.native import band_dp_native as jax_band_dp_native
from pyani_plus_tpu.ops import dp as jax_dp
from pyani_plus_tpu.ops import extend as jax_extend
from pyani_plus_tpu_torch import synthetic
from pyani_plus_tpu_torch.native import band_dp_native
from pyani_plus_tpu_torch.ops import dp, sw
from pyani_plus_tpu_torch.ops import extend as ext
from pyani_plus_tpu_torch.ops.extend_host import EXTEND, MATCH, MISMATCH, OPEN, extend_errors


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Row-serial small-tensor work: intra-op threads only add overhead."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _stats(a: np.ndarray, b: np.ndarray, **kwargs):
    """The port's stats DP, held equal to the JAX package's on the way."""
    port = dp.local_align_stats(a, b, **kwargs)
    jax = jax_dp.local_align_stats(a, b, **kwargs)
    assert (port is None) == (jax is None)
    if port is not None:
        assert dataclasses.astuple(port) == dataclasses.astuple(jax)
    return port


def _native_extension(a: np.ndarray, b: np.ndarray) -> tuple[int, ...]:
    i, j, _score, err, nid, gap = band_dp_native(a, b, 60, True, MATCH, MISMATCH, OPEN, EXTEND, 600)
    assert (i, j, _score, err, nid, gap) == jax_band_dp_native(
        a, b, 60, True, MATCH, MISMATCH, OPEN, EXTEND, 600
    )
    return i, j, err, nid, gap


def _pair(name: str) -> tuple[np.ndarray, np.ndarray]:
    a, b = synthetic.dp_pairs()[name]
    qa, qb = synthetic.DP_PAIRS[name]
    assert np.array_equal(a, jax_encode(qa)) and np.array_equal(b, jax_encode(qb))
    return a, b


def test_exact_match() -> None:
    a, _ = _pair("exact")
    st = _stats(a, a)
    assert (st.score, st.matches, st.mismatches, st.gaps) == (40, 20, 0, 0)


def test_single_mismatch() -> None:
    st = _stats(*_pair("one_mismatch"))
    assert (st.length, st.matches, st.mismatches) == (20, 19, 1)


def test_gap() -> None:
    st = _stats(*_pair("gap"))
    assert (st.gaps, st.gap_opens, st.matches) == (2, 1, 18)
    assert st.score == 27  # 18 * 2 - (5 + 2 * 2)


def test_n_never_matches() -> None:
    st = _stats(*_pair("n_run"))
    # the best local alignment keeps to one ACGT run: crossing 4 Ns costs 12 > 8
    assert (st.score, st.matches) == (8, 4)


def test_no_alignment_returns_none() -> None:
    assert _stats(*_pair("no_alignment")) is None


@pytest.mark.parametrize("name", sorted(synthetic.DP_PAIRS))
def test_named_pairs_through_both_batch_paths(name: str) -> None:
    """Each named input as one Smith-Waterman task (the winning cell of
    the stats DP) and as one free-end extension task (the native band
    kernel) through the port's CPU dispatch."""
    a, b = _pair(name)
    st = _stats(a, b)
    want = (0, 0, 0) if st is None else (st.score, st.query_end, st.subject_end)
    assert sw.batch_sw_best([(a, b)], "cpu") == [want] == sw.batch_sw_best_host([(a, b)])
    assert ext.batch_extend([(a, b)], "cpu") == [_native_extension(a, b)]


def test_jax_score_parity() -> None:
    from pyani_plus_tpu.ops.dp_jax import batch_local_align_scores

    tasks = synthetic.sw_score_parity_tasks()
    jax_scores = np.asarray(
        batch_local_align_scores(np.stack([q for q, _ in tasks]), np.stack([s for _, s in tasks]))
    )
    got = sw.batch_sw_best(tasks, "cpu")
    for i, (q, s) in enumerate(tasks):
        st = _stats(q, s)
        expected = 0 if st is None else st.score
        assert got[i][0] == jax_scores[i] == expected, i


def test_batch_extend_device_parity() -> None:
    """extend_jax's fuzz set (give-up rule, N codes, uneven lengths)
    through the port's CPU dispatch: equal to the JAX batch and to the
    native kernel, bit for bit."""
    from pyani_plus_tpu.ops.extend_jax import batch_extend_errors

    tasks = synthetic.extension_fuzz_tasks(23, 24, 1200)
    jax = batch_extend_errors(tasks, stop_rows=600)
    got = ext.batch_extend(tasks, "cpu")
    for idx, (a, b) in enumerate(tasks):
        assert got[idx] == tuple(int(v) for v in jax[idx]) == _native_extension(a, b), idx


def test_batch_extend_pallas_parity() -> None:
    """The Pallas kernel's fuzz set (interpret mode on the CPU) through the
    port's CPU dispatch: equal to the Pallas output and to the native
    kernel, bit for bit."""
    from pyani_plus_tpu.ops.extend_pallas import batch_extend_pallas

    tasks = synthetic.extension_fuzz_tasks(41, 20, 1100)
    pallas = batch_extend_pallas(tasks, stop_rows=600)
    got = ext.batch_extend(tasks, "cpu")
    for idx, (a, b) in enumerate(tasks):
        assert got[idx] == tuple(int(v) for v in pallas[idx]) == _native_extension(a, b), idx


def test_oversize_tasks_run_through_the_port() -> None:
    """The JAX package sends a task longer than its largest bucket to the
    host kernel; the port takes any length in one dispatch. Its results,
    in the callers' order, equal ``extend_errors`` (the port's and the
    JAX package's) and the JAX batch in the same positions."""
    from pyani_plus_tpu.ops.extend_pallas import M_COLS_BUCKETS, batch_extend_pallas

    assert M_COLS_BUCKETS[-1] == synthetic.EXTEND_BUCKET_LIMIT
    tasks = synthetic.extension_oversize_tasks()
    assert [a.size > M_COLS_BUCKETS[-1] for a, _ in tasks] == [True, False, True, False]
    got = ext.batch_extend(tasks, "cpu")
    jax = batch_extend_pallas(tasks, stop_rows=600)
    assert got[2][0] > M_COLS_BUCKETS[-1]  # the extension really ran that far
    for idx, (a, b) in enumerate(tasks):
        want = extend_errors(a, b)
        assert want == tuple(jax_extend.extend_errors(a, b))
        assert got[idx] == want == tuple(int(v) for v in jax[idx]), idx


def test_iupac_letter_equality_identities() -> None:
    """blastn counts identities by letter: W == W is an identity, W vs R
    a mismatch, though both columns score as mismatches."""
    q, s_same = _pair("iupac_same")
    _, s_diff = _pair("iupac_diff")
    st_same, st_diff = _stats(q, s_same), _stats(q, s_diff)
    assert st_same.score == st_diff.score
    assert st_same.length == st_diff.length == 42
    assert (st_same.matches, st_same.mismatches) == (42, 0)
    assert (st_diff.matches, st_diff.mismatches) == (40, 2)


def test_iupac_fuzz_native_numpy_parity() -> None:
    for q, s in synthetic.sw_iupac_fuzz_tasks():
        native = _stats(q, s)
        numpy_ = _stats(q, s, force_numpy=True)
        assert (native is None) == (numpy_ is None)
        if native is not None:
            assert dataclasses.astuple(native) == dataclasses.astuple(numpy_)


def test_batch_best_trim_equivalence_fuzz() -> None:
    """The best cell, from the JAX batch over the padded rows and from the
    port's plain version over the same rows and over the unpadded tasks,
    is the stats DP's first maximum in row-major order; the stats DP on
    the prefix domain query[:best_i] x subject[:best_j] equals the full
    one field for field."""
    from pyani_plus_tpu.ops.dp_jax import PAD_CODE, batch_local_align_best

    assert PAD_CODE == sw.PAD_CODE == synthetic.SW_PAD_CODE
    tasks = synthetic.sw_trim_fuzz_tasks()
    padded = synthetic.sw_padded(tasks)
    jax = np.asarray(batch_local_align_best(np.stack([q for q, _ in padded]),
                                            np.stack([s for _, s in padded])))  # fmt: skip
    port = sw.batch_sw_best(padded, "cpu")
    assert port == sw.batch_sw_best(tasks, "cpu") == sw.batch_sw_best_host(tasks)
    for i, (q, s) in enumerate(tasks):
        score, bi, bj = port[i]
        assert (score, bi, bj) == tuple(int(v) for v in jax[i]), i
        full = _stats(q, s)
        if full is None:
            assert score <= 0, (i, score)
            continue
        assert score == full.score, (i, score, full.score)
        assert (bi, bj) == (full.query_end, full.subject_end), i
        trimmed = _stats(q[:bi], s[:bj])
        assert dataclasses.astuple(trimmed) == dataclasses.astuple(full), i
