"""Rank 0 of a cell run as a process group: a configuration with
``"launch": K`` runs as ``pyani-plus-tpu-torch launch -n K -- <method>``
runs its workers, one process a rank, on one node.

The ``anibench.run`` process is rank 0. At set-up it writes the cell's
genomes, starts ranks 1 to K - 1 (``python -m anibench.rank``) with the
program's own variables of the group in their environment, as
``distributed.launch_local`` sets them, and nothing else, and every rank
runs the cell's warm-up: its first run of the method joins the program's
process group, which makes card ``rank % cards`` current. Set-up ends
when every rank has said it is ready. In the window rank 0 tells the
other ranks, through their pipes, to run each iteration, runs its own,
and waits for theirs; inside an iteration the program's broadcast of the
pending pairs and its all-gather of the rows are the only barriers. Rank 0
stores every row of an iteration in ``run_<k>.db``, and only that store is
judged: the other ranks' stores hold their share by design.

A rank that exits, or an iteration that takes more than ``LIMIT_FACTOR``
times ``--seconds`` (a rank that stalls), ends the run: rank 0 kills every
other rank by its PID and reports the run as not correct, with the error.
Where rank 0 itself does not come back within ``GRACE_S`` seconds of
that, it prints that result and exits; a run never waits for the process
group's own time-out.

What rank 0 reads from the group: ``peak_host_gib`` is the sum of each
rank's own peak resident set over the window (an upper bound on the
node's peak); ``setup_s`` is rank 0's age when the window opens;
``memory_peak_bytes`` is the fullest card's. The reference runs once the
window has closed, on every rank's card, a K-th of the pairs on each. In a
traced run each rank runs its own profiler, probes and span recorder, and
the readers get every rank's readings as ``data["ranks"]``.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from anibench import gen, judge
from anibench.probes import Refused
from anibench.rank import Channel, Lost, Member
from anibench.run import (
    HERE,
    built_files,
    cell,
    check_cards,
    collection_of,
    judge_stored,
    new_files,
    pairs_per_s,
    process_age,
    read_rows,
    timed_window,
)

LIMIT_FACTOR = 3  # an iteration may take this many times --seconds
READY_S = 900.0  # every rank's set-up, a checkout's first builds included
AFTER_S = 240.0  # the readings and the reference of every rank, after the window
GRACE_S = 60.0  # for rank 0 to come back once the other ranks are killed
# the program's variables of a group (``parallel/distributed.py``'s ENV_*),
# named here so that ranks start before rank 0 imports the program; a
# rank whose warm-up did not join the group fails its set-up
COORDINATOR = "PYANI_TPU_COORDINATOR"
NUM_PROCESSES = "PYANI_TPU_NUM_PROCESSES"
PROCESS_ID = "PYANI_TPU_PROCESS_ID"


class Peer:
    """Rank 0's handle on a rank it started: the process and its pipes."""

    def __init__(self, index: int, env: dict) -> None:
        self.index = index
        to_rank, from_rank = os.pipe(), os.pipe()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "anibench.rank", str(to_rank[0]), str(from_rank[1])],
            cwd=HERE.parent, env=env, pass_fds=(to_rank[0], from_rank[1]), stdin=subprocess.DEVNULL, stdout=2,
        )  # fmt: skip
        os.close(to_rank[0])
        os.close(from_rank[1])
        self.channel = Channel(from_rank[0], to_rank[1])

    def alive(self) -> bool:
        return self.proc.poll() is None

    def send(self, message: dict) -> None:
        try:
            self.channel.send(message)
        except OSError as err:
            raise Lost(f"rank {self.index}: {err}") from err

    def receive(self, until: float) -> dict:
        """The rank's next message, by the monotonic time ``until``."""
        try:
            message = self.channel.receive(max(until - time.monotonic(), 0.01), self.alive)
        except Lost as err:
            raise Lost(f"rank {self.index}: {err}") from err
        if "error" in message:
            raise Lost(message["error"])
        return message


class Group:
    """Ranks 1 to K - 1 and the watch over them while rank 0 runs the
    program: a rank that exits, or a deadline passed, kills them all."""

    def __init__(self, ranks: int, stuck) -> None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        os.environ.update({COORDINATOR: f"127.0.0.1:{port}", NUM_PROCESSES: str(ranks), PROCESS_ID: "0"})
        self.peers = [Peer(r, {**os.environ, PROCESS_ID: str(r)}) for r in range(1, ranks)]
        self.failure: str | None = None
        self._deadline: tuple[float, str] | None = None
        self._failed_at = 0.0
        self._stuck = stuck
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def until(self, seconds: float, what: str) -> float:
        """Give rank 0's current phase ``seconds``; the end, monotonic."""
        end = time.monotonic() + seconds
        self._deadline = (end, f"{what} took more than {seconds:g} s")
        return end

    def fail(self, why: str) -> None:
        """Record the first failure and kill every other rank."""
        with self._lock:
            if self.failure is None:
                self.failure, self._failed_at = why, time.monotonic()
        for peer in self.peers:
            if peer.alive():
                os.kill(peer.proc.pid, signal.SIGKILL)
        for peer in self.peers:
            peer.proc.wait()

    def _watch(self) -> None:
        while not self._done.wait(0.1):
            if self.failure is not None:
                if time.monotonic() - self._failed_at > GRACE_S:
                    self._stuck(f"{self.failure}; rank 0 did not come back within {GRACE_S:g} s")
                continue
            for peer in self.peers:
                code = peer.proc.poll()
                if code is not None:
                    self.fail(f"rank {peer.index} exited with code {code}")
            deadline = self._deadline
            if deadline is not None and time.monotonic() > deadline[0]:
                self.fail(f"{deadline[1]}: a rank stalled")

    def settle(self) -> None:
        """Rank 0 is back from the program: stop watching."""
        self._done.set()
        self._thread.join()

    def abandon(self, why: str) -> None:
        """Rank 0 cannot measure here: kill every rank, stop watching, and
        close (the caller then raises ``Refused``)."""
        self.fail(why)
        self.settle()
        self.close()

    def close(self, timeout: float = 30.0) -> None:
        """Wait for every rank to exit (killing any that outstays
        ``timeout``) and close the pipes."""
        end = time.monotonic() + timeout
        for peer in self.peers:
            try:
                peer.proc.wait(max(end - time.monotonic(), 0.01))
            except subprocess.TimeoutExpired:
                os.kill(peer.proc.pid, signal.SIGKILL)
                peer.proc.wait()
            peer.channel.close()


def run_group(name: str, seed: int, seconds: float, trace: bool, *, card: bool = True,  # noqa: C901, PLR0912, PLR0915
              overrides: dict | None = None) -> dict:  # fmt: skip
    """One run of a cell as a process group; returns the result line as a
    dict. ``card=False`` skips the look for the cards, and ``overrides``
    replaces keys of the collection and, under ``launch``, the number of
    ranks (tests only)."""
    bench, workload, config = cell(name)
    chips = next(w for w in bench["workloads"] if w["name"] == name)["chips"]
    overrides = dict(overrides or {})
    ranks = int(overrides.pop("launch", config["launch"]))
    collection = collection_of(workload, config, overrides)
    n_genomes = collection["clades"] * collection["per_clade"]
    all_pairs = [(q, s) for q in range(n_genomes) for s in range(n_genomes)]
    limits = config["limits"]
    work = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "anibench" / name
    shutil.rmtree(work, ignore_errors=True)
    libraries0 = built_files()
    device: dict = {}

    def stuck(why: str) -> None:  # rank 0 is caught in the program: give the result and go
        print(f"anibench: {why}", file=sys.stderr, flush=True)
        checks = {key: {"value": None, "limit": limit} for key, limit in limits.items()}
        line = {"correct": False, "attempted": len(all_pairs), "failed": len(all_pairs), "metrics": {},
                "device": {**device, "memory_peak_bytes": 0}, "checks": checks}  # fmt: skip
        print(json.dumps(line), flush=True)
        shutil.rmtree(work, ignore_errors=True)
        os._exit(0)

    group = Group(ranks, stuck)  # first: the ranks' start-up overlaps rank 0's
    try:
        import torch

        check_cards(torch, name, chips, card)
    except Refused:
        group.abandon("no cards")
        raise
    if torch.cuda.is_available():
        device.update(platform="gpu", kind=torch.cuda.get_device_name(0), count=ranks)
    else:  # tests only: the look for a card was skipped
        device.update(platform="cpu", kind="cpu", count=0)
    paths = gen.write_collection(collection, seed, work / "genomes")
    os.sync()  # the collection's pages reach the disk before the window, not during it
    me = Member(name, trace, 0, paths, work)
    error = None
    cards_used: list = []

    # ---- set-up: every rank warms up (and so joins the group), then is ready
    until = group.until(READY_S, "the ranks' set-up")
    try:
        for peer in group.peers:
            peer.send({"workload": name, "trace": trace, "rank": peer.index, "paths": [str(p) for p in paths],
                       "work": str(work)})  # fmt: skip
        me.setup()
        cards_used = [me.card] + [peer.receive(until)["ready"] for peer in group.peers]
    except Lost as err:
        error = str(err)
    except Refused:  # the program is not there, or does not import: no result
        group.abandon("rank 0 was refused")
        raise
    except (Exception, SystemExit) as err:  # noqa: BLE001 - reported as a failed run
        error = f"warm-up: {type(err).__name__}: {err}"
    setup_s = process_age()
    libraries1 = built_files()
    built = new_files(libraries0, libraries1)  # a checkout's first run builds here

    # ---- the window
    limit = LIMIT_FACTOR * seconds

    def iterate(k: int) -> None:
        until = group.until(limit, f"iteration {k}")
        for peer in group.peers:
            peer.send({"op": "run", "k": k})
        me.iterate(k)
        for peer in group.peers:
            peer.receive(until)

    with me.window():
        iterations, window_s, window_error = timed_window(0 if error else seconds, iterate)
    group.settle()
    error = group.failure or error or window_error
    if error is not None:
        group.fail(error)

    # ---- every rank's readings and its share of the reference
    readings = [me.finish()]
    ref_rows: dict | None = None
    ref_s = 0.0
    if error is None:
        until = time.monotonic() + AFTER_S
        shares = [all_pairs[r::ranks] for r in range(ranks)]
        try:
            for peer in group.peers:
                peer.send({"op": "stop", "pairs": shares[peer.index]})
            readings += [peer.receive(until)["readings"] for peer in group.peers]
            t_ref = time.perf_counter()
            rows = me.reference(shares[0])
            for peer in group.peers:
                rows += peer.receive(until)["reference"]
            ref_s = time.perf_counter() - t_ref
            ref_rows = {(q, s): row for q, s, row in rows}
        except Lost as err:
            error = str(err)
            group.fail(error)
    group.close()
    built_in_window = new_files(libraries1, built_files())
    for reading in readings:
        if reading["forbidden"]:
            raise Refused(f"rank {reading['rank']} loaded {', '.join(reading['forbidden'])}; the port must not")

    # ---- rank 0's rows of every iteration, judged against the reference
    stored = [read_rows(work / f"run_{k}.db") for k in range(len(iterations))]
    if error is not None:  # the run that failed counts with what it stored
        db = work / f"run_{len(iterations)}.db"
        stored.append(read_rows(db) if db.is_file() else {})
    numbers, failed = judge_stored(stored, ref_rows or {}, paths, all_pairs, config)
    if ref_rows is None:  # not judged: only the missing rows are known
        numbers = {key: value if key == "missing_rows" else None for key, value in numbers.items()}
    correct = error is None and bool(iterations) and judge.verdict(numbers, limits)
    device["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in readings)

    # ---- metrics
    breakdown = None
    if not trace:
        values = {
            "pairs_per_s": pairs_per_s(len(iterations), n_genomes, window_s),
            "peak_host_gib": sum(r["host_peak_bytes"] for r in readings) / 2**30,
            "setup_s": setup_s,
        }
        metrics = {
            metric["name"]: {"value": values[metric["name"]], "unit": metric["unit"]}
            for metric in bench["end_to_end"]
            if name in metric.get("workloads", [name])
        }
    else:
        timelines = [r["timeline"] for r in readings]
        data = {"ranks": readings, "iterations": iterations, "window_s": window_s, "genomes": n_genomes,
                "timeline": timelines[0]}  # fmt: skip
        metrics = {}
        for metric, reader in me.readers:
            value = reader.read(data)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        device["busy_s"] = sum(t["busy_s"] for t in timelines) / len(timelines)
        device["window_s"] = timelines[0]["window_s"]
        breakdown = _breakdown(readings)
    shutil.rmtree(work, ignore_errors=True)

    result = {"correct": correct, "attempted": len(stored) * len(all_pairs), "failed": failed, "metrics": metrics,
              "device": device}  # fmt: skip
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_built"] = {"built": bool(built), "libraries": built}
    result["checks"] = {key: {"value": numbers.get(key, 0.0), "limit": limit} for key, limit in limits.items()}
    result["_notes"] = {
        "setup_s": setup_s,
        "iterations_s": iterations,
        "window_s": window_s,
        "reference_s": ref_s,
        "checked_pairs": len(ref_rows or {}),
        "built_in_window": built_in_window,
        "seed": seed,
        "error": error,
        "limit_s": limit,
        "ranks": [
            {
                "rank": r["rank"],
                "card": r["card"],
                "host_peak_gib": r["host_peak_bytes"] / 2**30,
                "memory_peak_bytes": r["memory_peak_bytes"],
                "iterations_s": r["iterations"],
            }
            for r in readings
        ],
        "pids": [peer.proc.pid for peer in group.peers],
    }
    if error is None:
        result["_notes"]["cards"] = cards_used
    return result


def _breakdown(readings: list[dict]) -> dict:
    """The device operations by time summed over every rank's card, and
    the longest idle gaps of any, named by rank."""
    ops: dict[str, float] = {}
    for r in readings:
        for op, seconds in r["timeline"]["kernel_s"].items():
            ops[op] = ops.get(op, 0.0) + seconds
    gaps = [[f"rank {r['rank']} {gap}", seconds] for r in readings for gap, seconds in r["timeline"]["idle_gaps"]]
    return {
        "device_ops": [[op, t] for op, t in sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10],
    }
