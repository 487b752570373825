"""The port's span and counter recorder (``utils/spans.py``), on the CPU.

- Off (the default) it records nothing, takes no lock, reads no clock and
  opens no ``record_function``.
- On, a span records its name, parent, request and thread; a child opened
  in a pool thread names the parent it was handed; self seconds are the
  seconds less those of the children on the same thread; counters add up
  under 8 threads.
- Its clock is the profiler's: in a CPU ``torch.profiler`` session each
  span's start and end equal its range's ``ts`` plus the file's
  ``baseTimeNanoseconds`` within 0.1 ms.
- ``NAMES`` is every name the package records.
- Runs of sourmash and ANIm through ``start_and_run_method`` on synthetic
  genomes: every span of the runner's and the method's stages, the
  parses counted twice a genome, the sketches counted once a miss of the
  cache, every ``anim.*`` span with its pair, and the rows of an
  unrecorded run; ``PYANI_TPU_PROFILE`` writes one trace of the whole run
  that holds the runner's and sourmash's ranges, and runs ANIb's pipeline
  of side threads to the same rows.
- Runs of ANIb, through its pipeline and on the host route: every
  ``anib.*`` stage with its pair, ``anib.join`` inside ``anib.candidates``
  on its thread, ``anib.fragments`` equal to the stats DPs run, and the
  rows of an unrecorded run.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import json
import logging
import os
import sqlite3
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

import pyani_plus_tpu_torch
from pyani_plus_tpu_torch import synthetic
from pyani_plus_tpu_torch.methods import anib, sourmash
from pyani_plus_tpu_torch.ops import extend, minhash
from pyani_plus_tpu_torch.parallel import runner
from pyani_plus_tpu_torch.utils import spans

RUNNER = ["runner.md5", "runner.parse", "runner.genome_rows", "runner.load", "runner.compute",
          "runner.store", "runner.cache"]  # fmt: skip
SOURMASH = ["sourmash.sketch", "gram.prepare"]  # gram.device only where the mesh holds a card
ANIM = ["anim.pair", "anim.seed", "anim.cluster", "anim.chain", "anim.extend", "extend.wait",
        "anim.filter"]  # fmt: skip
ANIB = ["anib.index", "anib.candidates", "anib.join", "anib.stats"]
ANIB_PIPELINE = ["anib.submit", "sw.wait", "anib.drain"]  # batches scored apart from the host


def _touch(name: str, parent: spans.Span | None = None) -> int:
    with spans.span(name, parent=parent):
        return threading.get_native_id()


@pytest.fixture(autouse=True)
def _fresh_recorder():
    spans.reset()
    yield
    spans.reset()


def test_off_records_nothing(monkeypatch) -> None:
    class Refused:
        def __getattr__(self, name):
            raise AssertionError(f"the recorder is off, yet it touched {name}")

        def __enter__(self):
            raise AssertionError("the recorder is off, yet it took its lock")

    assert spans.ON is False
    monkeypatch.setattr(spans, "time", Refused())
    monkeypatch.setattr(spans, "torch", Refused())
    monkeypatch.setattr(spans, "_LOCK", Refused())
    assert spans.span("a") is spans.span("b", request=("q", "s"))  # one shared null context
    with spans.span("a"), spans.span("b"):
        spans.count("c", 3)
        assert spans.current() is None
    monkeypatch.undo()
    assert spans.totals() == {} and spans.counters() == {} and spans.recent() == []


def test_on_records_name_parent_request_and_thread() -> None:
    main = threading.get_native_id()
    with spans.recording():
        with spans.span("pair", request=("q", "s")) as pair:
            with spans.span("inner"):
                pass
            handed = spans.current()
            with ThreadPoolExecutor(max_workers=1) as pool:
                pool.submit(_touch, "pooled", handed).result()
            with ThreadPoolExecutor(max_workers=1) as pool:

                def work():
                    with spans.span("pooled_outer", parent=handed), spans.span("pooled_inner"):
                        return threading.get_native_id()

                worker = pool.submit(work).result()
        with spans.span("alone"):
            pass
    assert spans.ON is False
    got = {r.name: r for r in spans.recent()}
    assert got["pair"].parent is None and got["pair"].request == ("q", "s") and got["pair"].thread == main
    assert got["inner"].parent == pair.id and got["inner"].request == ("q", "s")
    assert got["inner"].thread == main
    for name in ("pooled", "pooled_outer"):
        assert got[name].parent == pair.id and got[name].request == ("q", "s")
        assert got[name].thread != main
    assert got["pooled_inner"].parent == got["pooled_outer"].id
    assert got["pooled_inner"].thread == got["pooled_outer"].thread == worker
    assert got["pooled_inner"].request == ("q", "s")
    assert got["alone"].parent is None and got["alone"].request is None
    for record in got.values():
        assert record.start <= record.end


def test_self_seconds_are_less_the_children_on_the_same_thread() -> None:
    with spans.recording():
        with spans.span("outer"):
            time.sleep(0.01)
            with spans.span("child"):
                time.sleep(0.02)
            with spans.span("child"):
                time.sleep(0.01)
            handed = spans.current()
            with ThreadPoolExecutor(max_workers=1) as pool:  # another thread: not taken off
                pool.submit(_touch, "pooled", handed).result()
    totals = spans.totals()
    outer, child = totals["outer"], totals["child"]
    assert child.count == 2 and outer.count == 1
    assert outer.self_seconds == pytest.approx(outer.seconds - child.seconds, abs=1e-9)
    assert outer.self_seconds >= 0.01
    assert child.self_seconds == pytest.approx(child.seconds, abs=1e-9)
    assert outer.top_seconds == outer.seconds and child.top_seconds == 0.0
    assert totals["pooled"].top_seconds == 0.0


def test_counters_and_totals_add_up_under_8_threads() -> None:
    """8 threads at least, more than the cores, switching as often as the
    interpreter allows: a lost update would show in a count."""
    threads = max(8, (os.cpu_count() or 1) + 1)

    def work(_):
        for _ in range(1000):
            spans.count("hits")
            spans.count("pairs", 2)
            with spans.span("tick"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.recording(), ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(work, range(threads), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert spans.counters() == {"hits": 1000 * threads, "pairs": 2000 * threads}
    assert spans.totals()["tick"].count == 1000 * threads
    assert len(spans.recent()) == 1000 * threads


def test_recent_spans_are_bounded(monkeypatch) -> None:
    monkeypatch.setattr(spans, "_RECENT", spans.deque(maxlen=5))
    with spans.recording():
        for k in range(12):
            with spans.span(f"s{k}"):
                pass
    assert [r.name for r in spans.recent()] == [f"s{k}" for k in range(7, 12)]
    assert len(spans.totals()) == 12


def _ranges(path) -> tuple[dict[str, list[tuple[float, float]]], list]:
    """Each user range of a chrome trace on the wall clock, in seconds:
    ``ts`` plus the file's ``baseTimeNanoseconds``."""
    trace = json.loads(path.read_text())
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    ranges: dict[str, list[tuple[float, float]]] = {}
    for event in trace["traceEvents"]:
        if event.get("ph") == "X" and event.get("cat") == "user_annotation":
            start = (base_us + float(event["ts"])) * 1e-6
            ranges.setdefault(event["name"], []).append((start, start + float(event["dur"]) * 1e-6))
    return ranges, trace["traceEvents"]


def test_the_spans_clock_is_the_profilers(tmp_path) -> None:
    names = [f"clock.{k}" for k in range(4)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                experimental_config=runner._ALL_THREADS) as prof:  # fmt: skip
        assert spans.profiling()
        with torch.profiler.record_function("warm-up"):
            pass
        with spans.recording():
            for name in names:
                with spans.span(name):
                    time.sleep(0.003)
            with ThreadPoolExecutor(max_workers=1) as pool:
                pool.submit(_touch, "clock.pool").result()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    ranges, _ = _ranges(tmp_path / "trace.json")
    recorded = {r.name: r for r in spans.recent()}
    for name in [*names, "clock.pool"]:
        ((start, end),) = ranges[name]
        assert abs(recorded[name].start - start) < 1e-4, (name, recorded[name].start - start)
        assert abs(recorded[name].end - end) < 1e-4, (name, recorded[name].end - end)


def _recorded_names() -> set[str]:
    """The literal first argument of every ``spans.span`` and
    ``spans.count`` call in the package."""
    found = set()
    for path in Path(pyani_plus_tpu_torch.__file__).parent.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name) and node.func.value.id == "spans"
                    and node.func.attr in ("span", "count") and node.args
                    and isinstance(node.args[0], ast.Constant)):  # fmt: skip
                found.add(node.args[0].value)
    return found


def test_names_are_every_name_the_package_records() -> None:
    assert _recorded_names() == set(spans.NAMES)


def _rows(db) -> list[tuple]:
    with contextlib.closing(sqlite3.connect(db)) as conn:
        return sorted(conn.execute("SELECT query_hash, subject_hash, identity, aln_length, sim_errors,"
                                   " cov_query, cov_subject FROM comparisons").fetchall())


def _run(tmp_path, genomes, method: str, tag: str, **params) -> list[tuple]:
    db = tmp_path / f"{tag}.db"
    runner.start_and_run_method(logging.getLogger(__name__), db, genomes, method, create_db=True,
                                cache=tmp_path / f"cache_{tag}", **params)  # fmt: skip
    return _rows(db)


@pytest.fixture
def device_gram(monkeypatch):
    """sourmash sends its counts to the device Gram (at 64 genomes and
    2^18 hashes it does so by itself), here the plain PyTorch one."""
    monkeypatch.setattr(sourmash, "containment_ani",
                        functools.partial(minhash.containment_ani, use_device=True))  # fmt: skip


def test_a_sourmash_run_records_every_stage(tmp_path, device_gram) -> None:
    paths = synthetic.write_clade_dir(tmp_path / "g", 20_000, 2, [0.01, 0.03, 0.05], 41)
    plain = _run(tmp_path, paths[0].parent, "sourmash", "plain", scaled=100)
    assert spans.totals() == {}
    with spans.recording():
        recorded = _run(tmp_path, paths[0].parent, "sourmash", "recorded", scaled=100)
    assert recorded == plain and len(plain) == len(paths) ** 2
    totals = spans.totals()
    assert set(RUNNER + SOURMASH) <= set(totals), sorted(totals)
    assert "gram.device" not in totals  # the Gram ran, on a CPU mesh: no batch of the card
    assert spans.counters() == {"runner.parses": 2 * len(paths), "sourmash.sketches": len(paths)}
    assert totals["runner.parse"].count == 2 * len(paths)
    assert totals["sourmash.sketch"].count == len(paths) and totals["gram.prepare"].count == 1
    # the second parse lies inside runner.load, the first is top-level
    assert totals["runner.load"].seconds >= totals["runner.load"].self_seconds >= 0
    assert totals["runner.parse"].top_seconds < totals["runner.parse"].seconds
    assert totals["runner.compute"].self_seconds < totals["runner.compute"].seconds
    # a second run on the same cache reads every sketch back: none computed
    spans.reset()
    with spans.recording():
        runner.start_and_run_method(logging.getLogger(__name__), tmp_path / "again.db", paths[0].parent,
                                    "sourmash", create_db=True, cache=tmp_path / "cache_recorded",
                                    scaled=100)  # fmt: skip
    assert _rows(tmp_path / "again.db") == plain
    assert "sourmash.sketches" not in spans.counters() and "sourmash.sketch" not in spans.totals()


def test_an_anim_run_records_every_stage_with_its_pair(tmp_path, monkeypatch) -> None:
    """The contig pair leaves extension tails, which go through the
    batched path's submit and collect (``PYANI_TPU_EXTEND_BATCH_MIN=1``),
    there on the native host kernel, the plain version's oracle, so that
    the run stays short."""
    monkeypatch.setenv("PYANI_TPU_EXTEND_BATCH_MIN", "1")
    monkeypatch.setattr(extend, "batch_extend_reference", extend.batch_extend_host)
    paths = synthetic.write_contig_pair(tmp_path / "g", 43)
    plain = _run(tmp_path, paths[0].parent, "ANIm", "plain")
    with spans.recording():
        recorded = _run(tmp_path, paths[0].parent, "ANIm", "recorded")
    assert recorded == plain and len(plain) == 4
    totals = spans.totals()
    assert set(RUNNER + ANIM) <= set(totals), sorted(totals)
    counters = spans.counters()
    assert sorted(counters) == ["anim.native_gaps", "anim.seed_candidates", "runner.parses"]
    assert counters["runner.parses"] == 4 and counters["anim.native_gaps"] > 0 and counters["anim.seed_candidates"] > 0
    md5 = {row[0] for row in plain}
    records = spans.recent()
    pairs = {r.request for r in records if r.name == "anim.pair"}
    assert len(pairs) == 4 and all(q in md5 and s in md5 for q, s in pairs)
    for record in records:
        if record.name.startswith("anim.") or record.name == "extend.wait":
            assert record.request in pairs, record
    # two contigs a genome: 4 record pairs a genome pair, 2 strands each
    assert totals["anim.seed"].count == totals["anim.cluster"].count == 4 * 4 * 2
    assert totals["anim.extend"].self_seconds <= totals["anim.extend"].seconds


def test_the_profiler_trace_holds_the_whole_run(tmp_path, monkeypatch, device_gram) -> None:
    paths = synthetic.write_clade_dir(tmp_path / "g", 20_000, 2, [0.01, 0.03], 47)
    monkeypatch.setenv("PYANI_TPU_PROFILE", str(tmp_path / "trace"))
    _run(tmp_path, paths[0].parent, "sourmash", "traced", scaled=100)
    assert spans.ON is False and not spans.profiling()
    (trace,) = (tmp_path / "trace").iterdir()
    assert trace.name == f"trace-{os.getpid()}.json"
    ranges, _ = _ranges(trace)
    for name in ("runner.md5", "runner.load", "runner.compute", "runner.store", "runner.cache",
                 "sourmash.sketch", "gram.prepare"):  # fmt: skip
        assert name in ranges, sorted(ranges)
    assert len(ranges["runner.parse"]) == 2 * len(paths)
    (compute,) = ranges["runner.compute"]
    assert all(compute[0] <= a <= b <= compute[1] for a, b in ranges["sourmash.sketch"])
    (md5,) = ranges["runner.md5"]
    assert md5[1] <= ranges["runner.load"][0][0] <= compute[0]


def test_anib_under_the_profiler_gives_the_rows_of_a_plain_run(tmp_path, monkeypatch) -> None:
    """ANIb's pipeline (``PYANI_TPU_ANIB_DEVICE=1``: its batches submitted
    on the compute thread and collected on side threads, here scored by
    the plain version) in one profiler session of the whole run."""
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "1")
    paths = synthetic.write_genome_dir(tmp_path / "g", 3_000, [0.02, 0.05], 53)
    plain = _run(tmp_path, paths[0].parent, "ANIb", "plain")
    monkeypatch.setenv("PYANI_TPU_PROFILE", str(tmp_path / "trace"))
    assert _run(tmp_path, paths[0].parent, "ANIb", "traced") == plain and len(plain) == len(paths) ** 2
    assert spans.ON is False and not spans.profiling()
    (trace,) = (tmp_path / "trace").iterdir()
    ranges, _ = _ranges(trace)
    assert len(ranges["runner.compute"]) == 1 and ranges["runner.store"]
    assert len(ranges["runner.parse"]) == 2 * len(paths)


@pytest.mark.parametrize("device", ["1", "0"], ids=["pipeline", "host"])
def test_an_anib_run_records_every_stage_with_its_pair(tmp_path, monkeypatch, device) -> None:
    """``PYANI_TPU_ANIB_DEVICE=1``: the batches submitted on the compute
    thread and collected on side threads (here scored by the plain
    version); ``0``: the host scorer, no batch."""
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", device)
    paths = synthetic.write_genome_dir(tmp_path / "g", 3_000, [0.02, 0.05], 53)
    plain = _run(tmp_path, paths[0].parent, "ANIb", "plain")
    assert spans.totals() == {}
    stats_dps = []
    real = anib.local_align_stats
    monkeypatch.setattr(anib, "local_align_stats", lambda *a, **k: stats_dps.append(1) or real(*a, **k))
    with spans.recording():
        recorded = _run(tmp_path, paths[0].parent, "ANIb", "recorded")
    n = len(paths)
    assert recorded == plain and len(plain) == n**2
    totals = spans.totals()
    names = ANIB + ANIB_PIPELINE if device == "1" else ANIB
    assert set(RUNNER + names) <= set(totals), sorted(totals)
    assert not set(ANIB_PIPELINE) & set(totals) if device == "0" else True
    assert spans.counters() == {"runner.parses": 2 * n, "anib.fragments": len(stats_dps)} and stats_dps
    # one record a genome: an index a column, a join a pair (both strands)
    assert totals["anib.index"].count == n
    assert totals["anib.candidates"].count == totals["anib.join"].count == totals["anib.stats"].count == n**2
    if device == "1":  # one group a column, so a batch a column
        assert totals["anib.submit"].count == totals["sw.wait"].count == n
        assert totals["anib.drain"].count >= 1
    candidates = totals["anib.candidates"]
    assert candidates.self_seconds == pytest.approx(candidates.seconds - totals["anib.join"].seconds, abs=1e-6)
    records = spans.recent()
    by_id = {r.id: r for r in records}
    md5 = {row[0] for row in plain}
    pairs = {r.request for r in records if r.name == "anib.candidates"}
    assert len(pairs) == n**2 and all(q in md5 and s in md5 for q, s in pairs)
    assert {r.request for r in records if r.name == "anib.stats"} == pairs
    for join in (r for r in records if r.name == "anib.join"):
        outer = by_id[join.parent]
        assert outer.name == "anib.candidates" and outer.thread == join.thread
        assert join.request == outer.request
        assert outer.start <= join.start <= join.end <= outer.end + 1e-6
