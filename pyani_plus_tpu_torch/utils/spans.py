"""Spans and counters of the program's stages, recorded only when asked for.

A span names one stage of a run (``runner.parse``, ``anim.seed``,
``extend.wait``, ...) over the time the stage takes; a counter adds up
integers at the same places (``runner.parses``). The recorder is off by
default. Then ``span`` checks the module flag ``ON`` and returns a shared
null context: it takes no lock, reads no clock and makes no torch call,
and ``count`` and ``current`` return at once. Switching it on:
``PYANI_TPU_PROFILE`` (``parallel/runner.py``) for its profiler session;
code through ``ON`` or ``recording()``.

When on, a span keeps its name, its start and end, the thread it ran on
(its native id, the trace's ``tid``), its parent and the request it
serves. The parent is the enclosing span on
that thread, or the span passed as ``parent`` for work handed to a pool
thread (``current()`` gives it to the caller). The request is inherited
from the parent unless given; for ANIm's ordered pairs it is (query md5,
subject md5), so that every span of one pair carries it; ANIb's spans
of one pair carry the same. The recorder
keeps, under one lock taken once at each span's end:

- per name, the count, the seconds, the self seconds (the seconds less
  those of its children on the same thread, which nest and so never
  overlap) and the top seconds (those of the spans without a parent);
- the integer counters;
- the most recent ``RECENT`` spans (``recent()``), a bounded list.

``NAMES`` lists every span and counter the program records; a reader of
the totals can tell a name the program dropped from one that did not
occur.

Clock: start and end are the wall clock in seconds, the start read when
the span opens and the end the start plus a monotonic duration. That is
the clock of ``torch.profiler``'s chrome trace, where an event's ``ts``
plus the file's ``baseTimeNanoseconds`` is the wall clock in
microseconds: on the CPU with torch 2.13, and on the H100 with torch
2.11 and CUDA 12.8, where the kernels' events are on the same clock.
While a profiler session is active, each span also opens
``torch.profiler.record_function(<name>)``, so that its range lies in the
same trace as the kernels, for every thread the session traces. The
recorded start is read just after the range opens and the end just after
it closes. On a thread that holds the interpreter's lock alone they lie
within about 0.1 ms of the range's own ends (3-100 us measured), but for
the first range of a profiler session, which opens about 1.3 ms before
its span (``PYANI_TPU_PROFILE`` opens a range over the whole run first).
Threads that contend for the lock (ANIm's pair and strand threads) may
wait for it between the two readings, for milliseconds.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from collections.abc import Iterator
from typing import NamedTuple

import torch

ON = False
RECENT = 65536
NAMES = frozenset((
    # parallel/runner.py
    "runner.md5", "runner.parse", "runner.parses", "runner.genome_rows", "runner.load",
    "runner.compute", "runner.store", "runner.cache",
    # methods/anim.py, ops/extend.py
    "anim.pair", "anim.seed", "anim.cluster", "anim.chain", "anim.extend", "anim.filter",
    "anim.native_gaps", "extend.wait",
    # ops/suffix.py
    "anim.seed_lanes", "anim.seed_rewalked", "anim.seed_candidates",
    # methods/sourmash.py, ops/minhash.py
    "sourmash.sketch", "sourmash.sketches", "gram.prepare", "gram.device",
    # methods/anib.py
    "anib.index", "anib.candidates", "anib.join", "anib.submit", "sw.wait", "anib.stats",
    "anib.drain", "anib.fragments",
))  # fmt: skip

_LOCK = threading.Lock()
_LOCAL = threading.local()  # .stack: this thread's open spans, innermost last
_NULL = contextlib.nullcontext()
_IDS = itertools.count(1)
_TOTALS: dict[str, list[int]] = {}  # name -> [count, ns, self ns, top ns]
_COUNTERS: dict[str, int] = {}
_RECENT: deque[Record] = deque(maxlen=RECENT)


class Record(NamedTuple):
    """One finished span; ``parent`` is the parent's ``id``."""

    id: int
    name: str
    start: float
    end: float
    thread: int
    parent: int | None
    request: tuple | None


class Total(NamedTuple):
    count: int
    seconds: float
    self_seconds: float
    top_seconds: float


def profiling() -> bool:
    """Whether a ``torch.profiler`` session is active in this process (on
    any thread: the flag is the process's)."""
    return torch.autograd.profiler._is_profiler_enabled


def _stack() -> list[Span]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class Span:
    """An open span, a context manager (``span``)."""

    __slots__ = ("_kids", "_range", "_t0", "id", "name", "parent", "request", "start", "thread")

    def __init__(self, name: str, parent: Span | None, request: tuple | None) -> None:
        self.id = next(_IDS)
        self.name = name
        self.parent = parent
        self.request = request if request is not None or parent is None else parent.request
        self.thread = threading.get_native_id()
        self._kids = 0
        self._range = None

    def __enter__(self) -> Span:
        if profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start = time.time_ns()
        self._t0 = time.perf_counter_ns()
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        ns = time.perf_counter_ns() - self._t0
        parent = self.parent
        if parent is not None and parent.thread == self.thread:
            parent._kids += ns
        record = Record(self.id, self.name, self.start * 1e-9, (self.start + ns) * 1e-9,
                        self.thread, None if parent is None else parent.id, self.request)  # fmt: skip
        with _LOCK:
            total = _TOTALS.get(self.name)
            if total is None:
                total = _TOTALS[self.name] = [0, 0, 0, 0]
            total[0] += 1
            total[1] += ns
            total[2] += ns - self._kids
            if parent is None:
                total[3] += ns
            _RECENT.append(record)


def span(name: str, *, parent: Span | None = None, request: tuple | None = None):
    """A context manager over one stage: a recorded span when the recorder
    is on, else a shared null context."""
    if not ON:
        return _NULL
    return Span(name, parent if parent is not None else current(), request)


def current() -> Span | None:
    """The innermost open span of this thread, to hand to a pool thread as
    ``parent``; None when the recorder is off."""
    if not ON:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` when the recorder is on."""
    if not ON:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Switch the recorder on inside the block."""
    global ON
    saved, ON = ON, True
    try:
        yield
    finally:
        ON = saved


def totals() -> dict[str, Total]:
    """Per name: count, seconds, self seconds and top seconds so far."""
    with _LOCK:
        items = [(name, list(total)) for name, total in _TOTALS.items()]
    return {name: Total(c, ns * 1e-9, own * 1e-9, top * 1e-9) for name, (c, ns, own, top) in items}


def counters() -> dict[str, int]:
    with _LOCK:
        return dict(_COUNTERS)


def recent() -> list[Record]:
    with _LOCK:
        return list(_RECENT)


def reset() -> None:
    """Forget every total, counter and recent span."""
    with _LOCK:
        _TOTALS.clear()
        _COUNTERS.clear()
        _RECENT.clear()
