"""What the per-layer readers take from a ``torch.profiler`` chrome trace.

The device intervals are the trace's kernel, memcpy and memset events;
the window is the ``anibench.window`` range that ``run.py`` opens, and
the spans are its other ``anibench.*`` ranges (``ingest``, ``compute``,
``iteration``, ``gram``). Times are in seconds.
"""

from __future__ import annotations

import json
from pathlib import Path

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def _clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def read(path: Path) -> dict:
    events = json.loads(Path(path).read_text())["traceEvents"]
    device, ranges = [], {}
    for event in events:
        if event.get("ph") != "X":
            continue
        start = float(event["ts"]) * 1e-6
        end = start + float(event.get("dur", 0)) * 1e-6
        name = event.get("name", "")
        if event.get("cat") in DEVICE_CATS:
            device.append((start, end, name))
        elif event.get("cat") == "user_annotation" and name.startswith("anibench."):
            ranges.setdefault(name[len("anibench.") :], []).append((start, end))
    if "window" not in ranges:
        msg = f"{path}: no anibench.window range"
        raise ValueError(msg)
    lo, hi = ranges["window"][0]
    inside = [(max(s, lo), min(e, hi), name) for s, e, name in device if e > lo and s < hi]
    busy = _union([(s, e) for s, e, _ in inside])
    by_name: dict[str, float] = {}
    for s, e, name in inside:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    # idle gaps, each named by the span the host was in at its middle
    gaps = []
    edges = [lo, *[t for iv in busy for t in iv], hi]
    for s, e in zip(edges[::2], edges[1::2]):
        if e - s <= 0:
            continue
        mid = (s + e) / 2
        label = "rest"
        for span in ("ingest", "compute"):
            if any(a <= mid <= b for a, b in ranges.get(span, [])):
                label = span
        if not any(a <= mid <= b for a, b in ranges.get("iteration", [])):
            label = "between runs"
        gaps.append((f"idle in {label}", e - s))
    gaps.sort(key=lambda g: -g[1])
    return {
        "window_s": hi - lo,
        "busy_s": sum(e - s for s, e in busy),
        "kernel_s": by_name,
        "device_ops": [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n, t] for n, t in gaps[:10]],
        "device": inside,
        "ranges": ranges,
    }


def device_seconds_within(timeline: dict, span: str) -> float:
    """The union of device time that lies inside the ranges of ``span``."""
    total = 0.0
    intervals = [(s, e) for s, e, _ in timeline["device"]]
    for lo, hi in timeline["ranges"].get(span, []):
        total += sum(e - s for s, e in _union(_clip(intervals, lo, hi)))
    return total
