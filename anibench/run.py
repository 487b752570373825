"""Run one cell of the port's benchmark.

    python -m anibench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. Set-up writes the cell's genome collection under ``TMPDIR``
from the seed and warms the program up on the cell's own shapes. The
window then drives ``pyani_plus_tpu_torch.parallel.runner
.start_and_run_method``, the function behind the ``anim`` and
``sourmash`` commands, with the commands' defaults: one iteration is one
whole all-vs-all run of the collection into a new SQLite store, and
iterations begin while less than ``--seconds`` has passed. Once the
window has closed, the rows of every iteration are read back and judged
against the plain reference of ``anibench/reference/<method>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (ordered pairs of the iterations), ``failed`` (pairs
missing or out of a limit), ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones, as BENCHMARK.json lists them),
``device``, with ``--trace 1``
``breakdown``, ``setup_built`` (whether set-up built the program's
compiled libraries, as the first run in a checkout does, and which), and
last ``checks``, each compared number beside its limit. The checks are
also the last lines of standard error.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import importlib
import importlib.util
import json
import logging
import os
import shutil
import sqlite3
import sys
import tempfile
import threading
import time
from pathlib import Path

from anibench.probes import Probes, Refused

HERE = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pyani_plus_tpu"})
FIELDS = ["identity", "aln_length", "sim_errors", "cov_query", "cov_subject"]


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_file(path: Path, name: str):
    """The module in ``path`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise Refused(f"no file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(name: str) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json, the workload's file, its configuration's file)."""
    bench = load_json(HERE.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    return bench, workload, config


def process_age() -> float:
    """Seconds since this process started (interpreter start included)."""
    ticks = os.sysconf("SC_CLK_TCK")
    start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return uptime - start / ticks


class HostPeak:
    """The highest resident set of this process over an interval, read
    from ``/proc/self/status``: VmHWM after ``clear_refs`` has reset it,
    or, where the kernel refuses the reset, VmRSS sampled every 20 ms."""

    def __init__(self) -> None:
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    @staticmethod
    def _read(key: str) -> int:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith(key):
                return int(line.split()[1]) * 1024
        return 0

    def _sample(self) -> None:
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._read("VmRSS:"))

    def start(self) -> None:
        try:
            Path("/proc/self/clear_refs").write_text("5")
            self._hwm = True
        except OSError:
            self._hwm = False
            self._thread.start()
        self.peak = self._read("VmRSS:")

    def stop(self) -> int:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()
        if self._hwm:
            self.peak = max(self.peak, self._read("VmHWM:"))
        return max(self.peak, self._read("VmRSS:"))


def import_program() -> dict:
    """The program's modules that the harness drives or reads."""
    try:
        from pyani_plus_tpu_torch.ops import minhash, suffix
        from pyani_plus_tpu_torch.parallel import runner
    except ImportError as err:
        raise Refused(f"the program does not import here: {err}") from err
    return {"runner": runner, "minhash": minhash, "suffix": suffix}


def built_files() -> dict[str, int]:
    """The program's compiled libraries (``*.so`` anywhere in its package,
    which builds them at first use) with their modification times."""
    spec = importlib.util.find_spec("pyani_plus_tpu_torch")
    if spec is None or not spec.submodule_search_locations:
        return {}
    root = Path(next(iter(spec.submodule_search_locations)))
    return {str(f.relative_to(root)): f.stat().st_mtime_ns for f in root.rglob("*.so")}


def new_files(before: dict[str, int], after: dict[str, int]) -> list[str]:
    return sorted(name for name, mtime in after.items() if before.get(name) != mtime)


def timed_window(seconds: float, iterate, clock=time.perf_counter) -> tuple[list[float], float, str | None]:
    """Call ``iterate(k)`` for k = 0, 1, ... while less than ``seconds``
    has passed since the first began. Returns each call's seconds, the
    time from the first call's start to the last one's end, and the error
    that stopped a call, if one did (the window ends there)."""
    sync = _synchronize()
    durations: list[float] = []
    t0 = clock()
    while clock() - t0 < seconds:
        start = clock()
        try:
            iterate(len(durations))
        except (Exception, SystemExit) as err:  # noqa: BLE001 - reported as a failed run
            sync()
            return durations, clock() - t0, f"{type(err).__name__}: {err}"
        sync()
        durations.append(clock() - start)
    return durations, clock() - t0, None


def _synchronize():
    import torch

    return torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)


def pairs_per_s(iterations: int, genomes: int, window_s: float) -> float:
    """All N^2 ordered pairs of every iteration over the whole window."""
    return iterations * genomes * genomes / window_s if window_s > 0 else 0.0


def collection_of(workload: dict, config: dict, overrides: dict | None = None) -> dict:
    """The generator's parameters of a cell: the workload's clades and
    rates, the configuration's genome count and length."""
    collection = {**workload["collection"], "length": config["genome_length"]}
    collection["per_clade"] = config["genomes"] // collection["clades"]
    collection.update(overrides or {})
    return collection


def clear_caches(program: dict) -> None:
    """Empty the program's process-wide seed index cache (suffix automata
    of earlier runs' genomes) and collect garbage."""
    cache = getattr(program["suffix"], "SEED_CACHE", None)
    if cache is not None:
        cache.clear()
    gc.collect()


def read_rows(db: Path) -> dict[tuple[str, str], dict]:
    con = sqlite3.connect(db)
    try:
        cur = con.execute(f"SELECT query_hash, subject_hash, {', '.join(FIELDS)} FROM comparisons")
        return {(q, s): dict(zip(FIELDS, rest)) for q, s, *rest in cur}
    finally:
        con.close()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, card: bool = True, overrides: dict | None = None) -> dict:  # noqa: C901, PLR0912, PLR0915
    """One run; returns the result line as a dict. ``card=False`` (tests
    only) skips the look for a CUDA card; ``overrides`` replaces keys of
    the workload's collection (tests only)."""
    import torch

    from anibench import gen, judge

    bench, workload, config = cell(name)
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    chips = entry["chips"]
    if card and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise Refused(f"{name} needs {chips} CUDA card(s); this machine has "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    libraries0 = built_files()
    program = import_program()
    runner = program["runner"]
    method = config["method"]
    collection = collection_of(workload, config, overrides)
    n_genomes = collection["clades"] * collection["per_clade"]
    warm = importlib.import_module(f"anibench.warmup.{method.lower()}")
    reference = importlib.import_module(f"anibench.reference.{method.lower()}")

    work = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "anibench" / name
    shutil.rmtree(work, ignore_errors=True)
    genomes_dir = work / "genomes"
    paths = gen.write_collection(collection, seed, genomes_dir)
    os.sync()  # the collection's pages reach the disk before the window, not during it
    logger = logging.getLogger("anibench.program")
    logger.propagate = False
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("program %(levelname)s %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.WARNING)
    params = config["params"]

    def one_run(directory: Path, db: Path, cache: Path) -> None:
        runner.start_and_run_method(logger, db, directory, method, cmdline="anibench", create_db=True, cache=cache, **params)

    try:
        warm.warm(program=program, paths=paths, work=work / "warm", run=one_run, config=config)
        warm_error = None
    except (Exception, SystemExit) as err:  # noqa: BLE001 - reported as a failed run
        warm_error = f"warm-up: {type(err).__name__}: {err}"

    built = new_files(libraries0, built_files())  # a checkout's first run builds here
    readers = [
        (metric, load_file(HERE / "metrics" / f"{metric['name']}.py", f"anibench_metric_{metric['name']}"))
        for metric in bench["per_layer"]
        if name in metric.get("workloads", [name])
    ]
    probes = prof = None
    if trace:
        probes = Probes(torch)
        try:
            for _metric, reader in readers:
                if hasattr(reader, "install"):
                    reader.install(probes)
        except Exception:
            probes.close()
            raise
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()  # the profiler's start-up is set-up
        if torch.cuda.is_available():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    host = HostPeak()
    host.start()
    setup_s = process_age()
    libraries1 = built_files()

    # ---- the window
    def iterate(k: int) -> None:
        clear_caches(program)  # each run starts as a fresh process would
        with torch.profiler.record_function("anibench.iteration"):
            one_run(genomes_dir, work / f"run_{k}.db", work / f"cache_{k}")

    try:
        with torch.profiler.record_function("anibench.window"):
            iterations, window_s, error = timed_window(0 if warm_error else seconds, iterate)
    finally:
        if probes is not None:
            probes.close()
    error = warm_error or error
    host_peak = host.stop()
    if prof is not None:
        prof.stop()
    built_in_window = new_files(libraries1, built_files())
    if torch.cuda.is_available():
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    else:  # tests only: the look for a card was skipped
        device = {"platform": "cpu", "kind": "cpu", "count": 0}
    device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if torch.cuda.is_available() else 0

    # ---- the rows of every iteration, judged once the window has closed
    clear_caches(program)  # the program's state is freed before the reference runs
    stored = [read_rows(work / f"run_{k}.db") for k in range(len(iterations))]
    if error is not None:  # the run that failed counts with what it stored
        db = work / ("warm/warm.db" if warm_error else f"run_{len(iterations)}.db")
        stored.append(read_rows(db) if db.is_file() else {})
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    all_pairs = [(q, s) for q in range(n_genomes) for s in range(n_genomes)]
    ref_device = "cuda" if torch.cuda.is_available() else "cpu"
    t_ref = time.perf_counter()
    ref_rows = reference.compute(paths, all_pairs, ref_device, params)
    ref_s = time.perf_counter() - t_ref
    md5 = {i: reference_md5(p) for i, p in enumerate(paths)}
    want = {(md5[q], md5[s]): row for (q, s), row in ref_rows.items()}
    every = {(md5[q], md5[s]) for q, s in all_pairs}
    fields = config["fields"]
    limits = config["limits"]
    numbers: dict[str, float] = {}
    failed = 0
    for rows in stored:
        got, bad = judge.compare(rows, want, fields, limits)
        missing = len(every - set(rows))
        got["missing_rows"] = float(missing)
        failed += bad + missing
        judge.merge(numbers, got)
    correct = error is None and bool(iterations) and judge.verdict(numbers, limits)
    attempted = len(stored) * len(all_pairs)

    # ---- metrics
    if not trace:
        values = {
            "pairs_per_s": pairs_per_s(len(iterations), n_genomes, window_s),
            "peak_host_gib": host_peak / 2**30,
            "setup_s": setup_s,
        }
        metrics = {
            metric["name"]: {"value": values[metric["name"]], "unit": metric["unit"]}
            for metric in bench["end_to_end"]
            if name in metric.get("workloads", [name])
        }
        breakdown = None
    else:
        trace_path = work / "trace.json"
        prof.export_chrome_trace(str(trace_path))
        from anibench import tracing

        timeline = tracing.read(trace_path)
        data = {**probes.data, "iterations": iterations, "window_s": window_s, "genomes": n_genomes, "timeline": timeline}
        metrics = {}
        for metric, reader in readers:
            value = reader.read(data)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        device["busy_s"] = timeline["busy_s"]
        device["window_s"] = timeline["window_s"]
        breakdown = {"device_ops": timeline["device_ops"], "idle_gaps": timeline["idle_gaps"]}
        trace_path.unlink()
    shutil.rmtree(work, ignore_errors=True)

    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a run that built the program's libraries (a checkout's first) pays the
    # build in its setup_s; this says so, apart from the metric
    result["setup_built"] = {"built": bool(built), "libraries": built}
    result["checks"] = {key: {"value": numbers.get(key, 0.0), "limit": limit} for key, limit in limits.items()}
    result["_notes"] = {
        "setup_s": setup_s,
        "iterations_s": iterations,
        "window_s": window_s,
        "reference_s": ref_s,
        "checked_pairs": len(ref_rows),
        "built_in_window": built_in_window,
        "seed": seed,
        "error": error,
    }
    return result


def reference_md5(path: Path) -> str:
    """The genome's identity in the store: the MD5 of its file's bytes."""
    return hashlib.md5(path.read_bytes()).hexdigest()  # noqa: S324


def forbidden_modules() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & FORBIDDEN)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m anibench.run", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except Refused as err:
        print(f"anibench: {err}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"anibench: the run loaded {', '.join(found)}; the port must not", file=sys.stderr)
        return 3
    notes = result.pop("_notes")
    if result["setup_built"]["built"]:
        print(f"anibench: set-up built {', '.join(result['setup_built']['libraries'])}", file=sys.stderr)
    print(f"anibench notes: {json.dumps(notes)}", file=sys.stderr)
    for key, check in result["checks"].items():
        print(f"check {key}: {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
