"""The group cell (``"launch": K``) on the CPU at a tiny size: rank 0's
store holds the rows that a one-process run stores, the host peak sums
the ranks', a traced run reads every rank, and the one-process cells keep
the result line they had."""

from __future__ import annotations

import pytest

from anibench.run import run_cell
from anibench.tests.conftest import GROUP, GROUP_TINY, run_group, tiny


@pytest.fixture(scope="module")
def untraced(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("PYANI_TPU_TORCH_DEVICE", "cpu")
    try:
        yield run_group(tmp_path_factory.mktemp("group"), seed=2**31 + 11)
    finally:
        mp.undo()


def test_rank0_stores_the_rows_of_a_one_process_run(untraced, tmp_path):
    from anibench import gen
    from anibench.run import cell, collection_of, program_logger, read_rows
    from pyani_plus_tpu_torch.parallel import runner

    result = untraced["result"]
    assert result["correct"] is True and result["failed"] == 0, result
    assert len(untraced["stored"]) == len(result["_notes"]["iterations_s"]) >= 1
    _bench, workload, config = cell(GROUP)
    overrides = {k: v for k, v in GROUP_TINY.items() if k != "launch"}
    paths = gen.write_collection(collection_of(workload, config, overrides), 2**31 + 11, tmp_path / "genomes")
    runner.start_and_run_method(program_logger(), tmp_path / "one.db", paths[0].parent, "ANIb", create_db=True,
                                **config["params"])  # fmt: skip
    one = {f"{q} {s}": row for (q, s), row in read_rows(tmp_path / "one.db").items()}
    assert len(one) == 16
    for rows in untraced["stored"]:
        assert {f"{q} {s}": row for q, s, row in rows} == one


def test_peak_host_gib_sums_the_ranks(untraced):
    result = untraced["result"]
    ranks = result["_notes"]["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["host_peak_gib"] > 0 for r in ranks)
    assert result["metrics"]["peak_host_gib"]["value"] == pytest.approx(sum(r["host_peak_gib"] for r in ranks))
    assert set(result["metrics"]) == {"peak_host_gib", "setup_s"}
    assert untraced["left"] == []


def test_a_traced_group_reads_every_rank(tmp_path):
    out = run_group(tmp_path, seed=2**31 + 12, trace=True)
    result = out["result"]
    assert result["correct"] is True, result
    assert out["left"] == []
    metrics = result["metrics"]
    for name in ("dist.pending_s", "dist.merge_s", "dist.skew_s", "runner.pairs_per_s.launch4",
                 "runner.ingest_s.launch4", "method.compute_s.launch4", "device.idle_pct.launch4"):  # fmt: skip
        assert name in metrics, name
    assert all(metrics[m]["value"] > 0 for m in ("dist.pending_s", "dist.merge_s", "runner.ingest_s.launch4",
                                                 "method.compute_s.launch4", "runner.pairs_per_s.launch4"))  # fmt: skip
    assert metrics["dist.skew_s"]["value"] >= 0
    assert "sw.tasks_per_launch.launch4" not in metrics  # the CPU scores ANIb on the host: no B2 launch
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])


@pytest.mark.parametrize(("workload", "overrides", "end_to_end"), [
    ("anim_bact4.strains", tiny("ANIm"), {"peak_host_gib", "setup_s"}),
    ("sourmash_bact128.clades", tiny("sourmash"), {"peak_host_gib", "setup_s"}),
    ("anib_bact4.genus", {"length": 6000}, {"peak_host_gib", "setup_s"}),
])
def test_the_one_process_cells_keep_their_result_line(workload, overrides, end_to_end):
    result = run_cell(workload, 2**31 + 13, 0.3, False, card=False, overrides=overrides)
    notes = result.pop("_notes")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "setup_built", "checks"]
    assert result["correct"] is True
    assert set(result["metrics"]) == end_to_end
    assert list(result["device"]) == ["platform", "kind", "count", "memory_peak_bytes"]
    assert set(notes) == {"setup_s", "iterations_s", "window_s", "reference_s", "checked_pairs", "built_in_window",
                          "seed", "error"}  # fmt: skip
