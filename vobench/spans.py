"""Spans and call records set on the program from the benchmark's own files.

A metric names the program functions it reads as "module:attribute"
strings. `Recorder.install` replaces each attribute with a wrapper that
opens a `record_function` range ("vobench: <label>"), takes the host clock
(`time.time_ns`, the profiler's own time base) around the call, and, for a
call record, keeps what the metric's `args` function makes of the call's
arguments. `Recorder.remove` puts the originals back. Nothing is wrapped in
an untraced run, so the end-to-end metrics are read with no instrumentation.
"""

from __future__ import annotations

import functools
import importlib
import time
from collections import defaultdict

from torch.profiler import record_function


class Recorder:
    """Host spans (label -> [(start_ns, end_ns)]) and call records (label ->
    [args summary]) of the wrapped functions, while `active`."""

    def __init__(self):
        self.spans: dict[str, list[tuple[int, int]]] = defaultdict(list)
        self.calls: dict[str, list] = defaultdict(list)
        self.active = False
        self._saved: list[tuple[object, str, object]] = []

    def _wrap(self, target: str, label: str, args_fn=None) -> None:
        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        f = getattr(mod, attr)
        spans, calls = self.spans[label], self.calls[label]

        @functools.wraps(f)
        def wrapped(*a, **k):
            if not self.active:
                return f(*a, **k)
            if args_fn is not None:
                calls.append(args_fn(*a, **k))
            t0 = time.time_ns()
            try:
                with record_function(f"vobench: {label}"):
                    return f(*a, **k)
            finally:
                spans.append((t0, time.time_ns()))
        self._saved.append((mod, attr, f))
        setattr(mod, attr, wrapped)

    def install(self, readers) -> None:
        """Wrap what each reader's SPANS ({label: [targets]}) and CALLS
        ({label: ([targets], args_fn)}) name; a target named twice is
        wrapped once per label."""
        done = set()
        for r in readers:
            for label, targets in getattr(r, "SPANS", {}).items():
                for t in targets:
                    if (label, t) not in done:
                        done.add((label, t))
                        self._wrap(t, label)
            for label, (targets, args_fn) in getattr(r, "CALLS", {}).items():
                for t in targets:
                    if (label, t) not in done:
                        done.add((label, t))
                        self._wrap(t, label, args_fn)

    def remove(self) -> None:
        for mod, attr, f in reversed(self._saved):
            setattr(mod, attr, f)
        self._saved.clear()

    def seconds(self, label: str) -> list[float]:
        return [(b - a) / 1e9 for a, b in self.spans.get(label, [])]
