"""The program's own spans and counters (`sosvo_torch/utils/spans.py`), laid
over a traced run's window and device trace, for the per-layer readers that
read them.

Importing this module turns the program's tracer on. The harness loads the
per-layer readers, which import it, only for a `--trace 1` run, so a timed
run never records a span. Where the program has no tracer, `tracer` is None
and every reader that asks reads nothing.

`window(run)` keeps the spans that lie inside the device trace's window
(which leaves out the warm-up's) and the request spans that end in it. Once
per run it lays every device event, by its start, and every stretch of the
card's idle time under the innermost nested span open on the host at that
moment (`OUTSIDE` where none was); request spans stay out of the nesting.
Both are vectorised lookups into the change points of the innermost span,
which `vobench/trace.py` finds as it does for the benchmark's own spans.
It prints one line to standard error: `idle under no program span: X s of
Y s`, Y the window.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict

import numpy as np

from vobench import trace as trace_mod

try:
    from sosvo_torch.utils import spans as tracer
except ImportError:  # a program without its tracer
    tracer = None
else:
    tracer.enable()

OUTSIDE = "outside"


class Window:
    """The program's spans inside one traced window, with the device trace
    laid under them. `spans` maps each kept span's index in the tracer's list
    to the span; `frames` is the number of `step` spans."""

    def __init__(self, trace, spans, requests):
        t0 = time.perf_counter()
        lo, hi = trace.start_ns, trace.end_ns
        self.spans = {i: s for i, s in enumerate(spans)
                      if s.start_ns >= lo and 0 < s.end_ns <= hi}
        self.requests = [r for r in requests if lo <= r.end_ns <= hi]
        self.frames = sum(1 for s in self.spans.values() if s.name == "step")
        self.children: dict[int, list[int]] = defaultdict(list)
        for i, s in self.spans.items():
            if s.parent in self.spans:
                self.children[s.parent].append(i)

        # Change points of the innermost open span, from the window's start.
        by_name: dict[str, list[tuple[int, int]]] = defaultdict(list)
        for sp in self.spans.values():
            by_name[sp.name].append((sp.start_ns, sp.end_ns))
        times, names = trace_mod._innermost_timeline(by_name)
        times = [lo] + times
        names = [OUTSIDE] + [OUTSIDE if n == trace_mod.OUTSIDE else n for n in names]
        label_of = {n: k for k, n in enumerate(dict.fromkeys(names))}
        labels = np.array([label_of[n] for n in names], dtype=np.int64)
        times = np.maximum.accumulate(np.array(times, dtype=np.int64))
        self._busy_starts = np.array([a for a, _ in trace.busy], dtype=np.int64)
        self._busy_ends = np.array([b for _, b in trace.busy], dtype=np.int64)
        self._busy_before = np.concatenate([[0], np.cumsum(self._busy_ends - self._busy_starts)])

        # Device events by the innermost span open when each began.
        starts = np.fromiter((e[1] for e in trace.events), dtype=np.int64,
                             count=len(trace.events))
        seg = np.searchsorted(times, starts, side="right") - 1
        ops = np.bincount(labels[np.maximum(seg, 0)], minlength=len(label_of))
        # Idle time of each change-point segment, summed by its span.
        ends = np.append(times[1:], hi)
        idle = (ends - times) - (self.busy_until(ends) - self.busy_until(times))
        idle_by = np.bincount(labels, weights=idle.astype(np.float64), minlength=len(label_of))
        self.ops = {n: int(ops[k]) for n, k in label_of.items()}
        self.idle_ns = {n: float(idle_by[k]) for n, k in label_of.items()}

        idx = np.fromiter(self.spans, dtype=np.int64, count=len(self.spans))
        a = np.array([self.spans[i].start_ns for i in idx], dtype=np.int64)
        b = np.array([self.spans[i].end_ns for i in idx], dtype=np.int64)
        idle_in = (b - a) - (self.busy_until(b) - self.busy_until(a))
        self.span_idle_ns = dict(zip(idx.tolist(), idle_in.tolist()))
        print(f"idle under no program span: {self.idle_ns.get(OUTSIDE, 0.0) / 1e9:.3f} s of "
              f"{trace.window_s:.3f} s", file=sys.stderr)
        print(f"program spans: {len(self.spans)} spans, {len(self.requests)} requests and "
              f"{self.frames} frames in the window, {len(trace.events)} device events laid under "
              f"them in {time.perf_counter() - t0:.2f} s", file=sys.stderr)

    def busy_until(self, t: np.ndarray) -> np.ndarray:
        """The card's busy ns in the window before each time of `t`."""
        if not len(self._busy_starts):
            return np.zeros_like(t)
        k = np.searchsorted(self._busy_starts, t, side="right") - 1
        kk = np.maximum(k, 0)
        inside = np.clip(t - self._busy_starts[kk], 0, self._busy_ends[kk] - self._busy_starts[kk])
        return np.where(k >= 0, self._busy_before[kk] + inside, 0)

    def stage(self, root: str, per: int, unit_ns: float) -> dict | None:
        """The host time in the spans named `root` over `per`, in units of
        `unit_ns`, and its parts: each direct child's name and `self` (the
        rest), which sum to the value, and `idle.<part>`, the card's idle time
        inside each part."""
        roots = [i for i, s in self.spans.items() if s.name == root]
        if not roots or per <= 0:
            return None
        host: dict[str, float] = defaultdict(float)
        idle: dict[str, float] = defaultdict(float)
        for r in roots:
            s = self.spans[r]
            host["self"] += s.end_ns - s.start_ns
            idle["self"] += self.span_idle_ns[r]
            for c in self.children.get(r, ()):
                cs = self.spans[c]
                d, d_idle = cs.end_ns - cs.start_ns, self.span_idle_ns[c]
                host[cs.name] += d
                host["self"] -= d
                idle[cs.name] += d_idle
                idle["self"] -= d_idle
        scale = 1.0 / (per * unit_ns)
        out = {"value": sum(host.values()) * scale}
        out.update({k: v * scale for k, v in host.items()})
        out.update({f"idle.{k}": v * scale for k, v in idle.items()})
        return out

    def counts_under(self, root: str) -> dict[str, int]:
        """Counts summed over the spans named `root` and every span inside them."""
        total: dict[str, int] = defaultdict(int)
        for i, s in self.spans.items():
            if not s.counts:
                continue
            j = i
            while j in self.spans and self.spans[j].name != root:
                j = self.spans[j].parent
            if j in self.spans:
                for k, n in s.counts.items():
                    total[k] += n
        return total

    def count(self, name: str) -> int:
        """The count `name` summed over every span."""
        return sum(s.counts.get(name, 0) for s in self.spans.values())

    def counts(self, prefix: str) -> dict[str, int]:
        """Counts whose name starts with `prefix`, summed over every span."""
        total: dict[str, int] = defaultdict(int)
        for s in self.spans.values():
            for k, n in s.counts.items():
                if k.startswith(prefix):
                    total[k] += n
        return total


_last: list = [None, None]  # (the trace, its Window): one per run, shared by the readers


def window(run) -> Window | None:
    """The run's `Window`, or None where the program has no tracer, the run
    has no device trace, or no frame was stepped inside the window."""
    if tracer is None or run.trace is None:
        return None
    if _last[0] is not run.trace:
        _last[0], _last[1] = run.trace, Window(run.trace, tracer.spans(), tracer.requests())
    w = _last[1]
    return w if w.frames > 0 else None
