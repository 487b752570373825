"""One rank of a cell run as a process group (a configuration with
``"launch": K``), as ``pyani-plus-tpu-torch launch -n K`` runs its workers.

The ``anibench.run`` process is rank 0 (``anibench/group.py``); it starts
ranks 1 to K - 1 as

    python -m anibench.rank <read fd> <write fd>

with the program's own variables of the group in their environment
(``PYANI_TPU_COORDINATOR``, ``PYANI_TPU_NUM_PROCESSES``,
``PYANI_TPU_PROCESS_ID``, as ``distributed.launch_local`` sets them) and
nothing else. The two descriptors are the rank's ends of two pipes, over
which rank 0 and the rank exchange JSON messages, one a line
(``Channel``). Every rank does its part through one ``Member``: the
cell's warm-up, which joins the program's process group and so makes the
rank's card current by the program's rule, then one iteration each time
rank 0 says ``run``, then its readings, then its share of the reference.

A rank touches no CUDA card before its warm-up: the card it uses is the
one the program makes current when it joins the group.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import select
import sys
import time
from pathlib import Path

from anibench import program_spans
from anibench.probes import Probes
from anibench.run import HERE, HostPeak, cell, clear_caches, forbidden_modules, import_program, load_file, program_logger


class Lost(Exception):
    """A rank did not answer: it exited, its pipe closed, or its time ran out."""


class Channel:
    """JSON messages, one a line, over a pipe to read and a pipe to write."""

    def __init__(self, read_fd: int, write_fd: int) -> None:
        self.read_fd, self.write_fd = read_fd, write_fd
        self._buffer = b""

    def send(self, message: dict) -> None:
        view = memoryview((json.dumps(message) + "\n").encode())
        while view:
            view = view[os.write(self.write_fd, view) :]

    def receive(self, timeout: float | None = None, alive=lambda: True) -> dict:
        """The next message; Lost when the pipe closes, when ``alive()``
        turns false while none is waiting, or after ``timeout`` seconds."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while b"\n" not in self._buffer:
            wait = 0.2 if deadline is None else min(0.2, deadline - time.monotonic())
            if wait <= 0:
                raise Lost(f"no message within {timeout:g} s")
            if select.select([self.read_fd], [], [], wait)[0]:
                chunk = os.read(self.read_fd, 1 << 16)
                if not chunk:
                    raise Lost("its pipe closed")
                self._buffer += chunk
            elif not alive():
                raise Lost("it exited")
        line, self._buffer = self._buffer.split(b"\n", 1)
        return json.loads(line)

    def close(self) -> None:
        for fd in (self.read_fd, self.write_fd):
            try:
                os.close(fd)
            except OSError:
                pass


class Member:
    """What each rank of a group does in a run, rank 0 included. Rank 0
    writes ``run_<k>.db``; rank r >= 1 its private ``run_<k>_rank<r>.db``,
    as ``launch``'s ``{rank}`` pattern names a worker's store."""

    def __init__(self, name: str, trace: bool, index: int, paths: list[Path], work: Path) -> None:
        import torch

        bench, _workload, self.config = cell(name)
        self.torch, self.trace, self.index, self.paths, self.work = torch, trace, index, paths, work
        self.iterations: list[float] = []
        self.readers = [
            (metric, load_file(HERE / "metrics" / f"{metric['name']}.py", f"anibench_metric_{metric['name']}"))
            for metric in bench["per_layer"]
            if name in metric.get("workloads", [name])
        ]
        self.card = self.probes = self.prof = self.host = None

    def own(self, stem: str) -> str:
        return stem if self.index == 0 else f"{stem}_rank{self.index}"

    def run(self, directory: Path, db: Path, cache: Path) -> None:
        runner = self.program["runner"]
        runner.start_and_run_method(self.logger, db, directory, self.config["method"], cmdline="anibench",
                                    create_db=True, cache=cache, **self.config["params"])  # fmt: skip

    def setup(self) -> None:
        """The warm-up (which joins the group), then, in a traced run, the
        probes and the profiler; then the window's peaks are reset."""
        torch = self.torch
        self.program = import_program()
        self.logger = program_logger()
        warm = importlib.import_module(f"anibench.warmup.{self.config['method'].lower()}")
        warm.warm(program=self.program, paths=self.paths, work=self.work / self.own("warm"), run=self.run,
                  config=self.config)  # fmt: skip
        if not importlib.import_module("pyani_plus_tpu_torch.parallel.distributed").is_initialized():
            raise RuntimeError("the warm-up did not join the program's process group")
        self.card = torch.cuda.current_device() if torch.cuda.is_available() else None
        if self.trace:
            self.probes = Probes(torch)
            try:
                for _metric, reader in self.readers:
                    if hasattr(reader, "install"):
                        reader.install(self.probes)
            except Exception:
                self.probes.close()
                raise
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.card is not None:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
            if self.card is not None:
                torch.ones(1, device="cuda").add_(1)
        if self.card is not None:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.host = HostPeak()
        self.host.start()

    def window(self):
        return self.torch.profiler.record_function("anibench.window")

    def iterate(self, k: int) -> float:
        """One whole run of the method into this rank's store ``k``."""
        t0 = time.perf_counter()
        clear_caches(self.program)  # each run starts as a fresh process would
        with self.torch.profiler.record_function("anibench.iteration"):
            self.run(self.paths[0].parent, self.work / f"{self.own(f'run_{k}')}.db", self.work / self.own(f"cache_{k}"))
        if self.card is not None:
            self.torch.cuda.synchronize()
        self.iterations.append(time.perf_counter() - t0)
        return self.iterations[-1]

    def finish(self) -> dict:
        """Close the window: the probes, the peaks and, in a traced run,
        the readings of the profiler's trace and the program's spans."""
        torch = self.torch
        if self.probes is not None:
            self.probes.close()
        readings = {
            "rank": self.index,
            "card": self.card,
            "host_peak_bytes": self.host.stop() if self.host is not None else 0,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if self.card is not None else 0,
            "iterations": self.iterations,
            "forbidden": forbidden_modules(),
        }
        if self.prof is not None:
            from anibench import tracing

            self.prof.stop()
            trace_path = self.work / f"{self.own('trace')}.json"
            self.prof.export_chrome_trace(str(trace_path))
            timeline = tracing.read(trace_path)
            trace_path.unlink()
            readings["timeline"] = {key: timeline[key] for key in ("window_s", "busy_s", "kernel_s", "device_ops", "idle_gaps")}
            data = self.probes.data
            readings["probes"] = {key: value for key, value in data.items() if key != program_spans.KEY}
            if program_spans.KEY in data:
                readings["program"] = _growth(data[program_spans.KEY])
        return readings

    def reference(self, pairs: list[list[int]]) -> list:
        """The plain reference's rows of ``pairs`` on this rank's card, once
        the program's state is freed: [[q, s, row], ...]."""
        clear_caches(self.program)
        gc.collect()
        device = "cpu"
        if self.card is not None:
            self.torch.cuda.empty_cache()
            device = f"cuda:{self.card}"
        reference = importlib.import_module(f"anibench.reference.{self.config['method'].lower()}")
        rows = reference.compute(self.paths, [tuple(p) for p in pairs], device, self.config["params"])
        return [[q, s, row] for (q, s), row in rows.items()]


def _growth(start: dict) -> dict:
    """The program's span totals and counters grown since ``start``."""
    spans = importlib.import_module(program_spans.MODULE)
    before = start["totals"]
    totals = {}
    for name, after in spans.totals().items():
        was = before.get(name)
        totals[name] = {field: getattr(after, field) - (getattr(was, field) if was else 0)
                        for field in ("count", "seconds", "self_seconds", "top_seconds")}  # fmt: skip
    counters = {name: n - start["counters"].get(name, 0) for name, n in spans.counters().items()}
    return {"totals": totals, "counters": counters}


# ---- what the readers of a group's metrics take from ``data["ranks"]``


def per_rank(data: dict, key: str) -> list | None:
    """Each rank's reading ``key``, or None where a rank has none."""
    ranks = data.get("ranks")
    if not ranks or any(key not in r for r in ranks):
        return None
    return [r[key] for r in ranks]


def span_seconds(data: dict, names: tuple[str, ...], field: str = "seconds") -> list[float] | None:
    """Each rank's ``field`` of the program's spans ``names``, summed, an
    iteration of that rank's."""
    programs = per_rank(data, "program")
    if programs is None or not all(r["iterations"] for r in data["ranks"]):
        return None
    for name in names:
        program_spans._declared(name)
    return [
        sum(program["totals"].get(name, {}).get(field, 0.0) for name in names) / len(r["iterations"])
        for program, r in zip(programs, data["ranks"])
    ]


def calls(data: dict, key: str) -> list[list[float]] | None:
    """Each rank's seconds of each call that ``install_collectives`` timed
    under ``key``, where every rank made one call an iteration."""
    probes = per_rank(data, "probes")
    if probes is None or any(key not in p for p in probes):
        return None
    out = [p[key] for p in probes]
    n = len(data["ranks"][0]["iterations"])
    if not n or any(len(c) != n for c in out):
        return None
    return out


def install_collectives(probes) -> None:
    """Time each call of the program's broadcast of rank 0's pending pairs
    (``dist.pending``) and of its all-gather of the rows (``dist.merge``),
    wrapped from outside; each is also an ``anibench.<key>`` range."""
    distributed = probes.module("pyani_plus_tpu_torch.parallel.distributed")
    for attr, key in (("broadcast_pending", "dist.pending"), ("allgather_comparisons", "dist.merge")):
        if key in probes.data:
            continue
        seconds = probes.data[key] = []

        def make(real, seconds=seconds, key=key):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    with probes.torch.profiler.record_function(f"anibench.{key}"):
                        return real(*args, **kwargs)
                finally:
                    seconds.append(time.perf_counter() - t0)

            return timed

        probes.replace(distributed, attr, make)


# ---- ranks 1 to K - 1


def main(argv: list[str] | None = None) -> int:
    read_fd, write_fd = (int(fd) for fd in (argv or sys.argv[1:]))
    channel = Channel(read_fd, write_fd)
    try:
        start = channel.receive()
        member = Member(start["workload"], start["trace"], start["rank"], [Path(p) for p in start["paths"]],
                        Path(start["work"]))  # fmt: skip
        member.setup()
        channel.send({"ready": member.card})
        with member.window():
            while (message := channel.receive())["op"] == "run":
                channel.send({"done": message["k"], "seconds": member.iterate(message["k"])})
        channel.send({"readings": member.finish()})
        channel.send({"reference": member.reference(message["pairs"])})
    except Lost:
        return 1  # rank 0 has gone
    except (Exception, SystemExit) as err:  # noqa: BLE001 - handed to rank 0, which fails the run
        try:
            channel.send({"error": f"rank {os.environ.get('PYANI_TPU_PROCESS_ID')}: {type(err).__name__}: {err}"})
        except OSError:
            pass
        return 1
    finally:
        channel.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
