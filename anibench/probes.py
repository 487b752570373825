"""What the per-layer readers install in the timed path of a traced run.

A reader (``metrics/<metric>.py``) that needs something from inside the
program defines ``install(probes)`` beside its ``read(data)``; the run
calls every install of the cell's metrics before the window and hands
each reader ``data``, which holds what the probes collected under the
keys the installs chose. Spans are shared: two readers that ask for the
same span get one wrapper. A name that the program no longer has is
refused, so that a renamed or folded function never moves its time
silently into another metric.
"""

from __future__ import annotations

import importlib
import threading
import time


class Refused(Exception):
    """The run cannot measure; the message says why."""


class Probes:
    def __init__(self, torch) -> None:
        self.torch = torch
        self.data: dict = {"spans": {}}
        self.lock = threading.Lock()
        self._undo: list[tuple[object, str, object]] = []
        self._spans: set[tuple[int, str, str]] = set()
        self._counters: dict[str, tuple[object, str, int]] = {}

    @staticmethod
    def module(name: str):
        """The program's module ``name``, or Refused."""
        try:
            return importlib.import_module(name)
        except ImportError as err:
            raise Refused(f"a per-layer probe needs {name}: {err}") from err

    def _original(self, module, attr: str):
        real = getattr(module, attr, None)
        if real is None:
            raise Refused(f"a per-layer probe needs {module.__name__}.{attr}, which the program no longer has")
        return real

    def replace(self, module, attr: str, make) -> None:
        """Set ``module.attr`` to ``make(current)``, undone by ``close``;
        a second replacement wraps the first."""
        real = self._original(module, attr)
        self._undo.append((module, attr, real))
        setattr(module, attr, make(real))

    def span(self, module, attr: str, name: str) -> None:
        """Host-clock seconds in ``module.attr``, summed under
        ``data["spans"][name]``, each call also an ``anibench.<name>``
        range of the profiler's trace. Asked for again, it is not wrapped
        twice."""
        key = (id(module), attr, name)
        if key in self._spans:
            return
        self._spans.add(key)
        seconds = self.data["spans"]

        def make(real):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    with self.torch.profiler.record_function(f"anibench.{name}"):
                        return real(*args, **kwargs)
                finally:
                    with self.lock:
                        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

            return timed

        self.replace(module, attr, make)

    def counter(self, module, attr: str, key: str) -> None:
        """The growth of the integer ``module.attr`` over the window, as
        ``data[key]``."""
        if key not in self._counters:
            self._counters[key] = (module, attr, int(self._original(module, attr)))

    def close(self) -> None:
        """Read the counters and put every original back."""
        for key, (module, attr, start) in self._counters.items():
            self.data[key] = int(getattr(module, attr)) - start
        self._counters.clear()
        for module, attr, real in reversed(self._undo):
            setattr(module, attr, real)
        self._undo.clear()
        self._spans.clear()
