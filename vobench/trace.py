"""The device trace of a traced run, reduced to what the metrics read.

The profiler records the card's activity alone (`ProfilerActivity.CUDA`:
kernels, copies and fills), so its cost on the host is one callback per
launch and not one record per operator. Its timestamps are the host's
`time.time_ns` base, the base of the benchmark's spans, so an idle gap on
the card can be laid beside the span that was open on the host. Reading a
window's trace costs about 16 us per recorded event (host and device)
inside the profiler's stop, and some 10 us per device event here.
"""

from __future__ import annotations

import bisect
import gc
import sys
import time
from collections import defaultdict
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "vobench: "  # the device-side copies of the benchmark's spans
OUTSIDE = "harness (no program span open)"
TOP = 10


class DeviceTrace(NamedTuple):
    start_ns: int
    end_ns: int
    events: list[tuple[str, int, int]]   # (name, start_ns, end_ns), clipped to the window
    busy: list[tuple[int, int]]           # the union of the events' intervals

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def kernel_seconds(self, fragment: str) -> list[float]:
        """Durations of the kernels whose name holds `fragment`."""
        return [(b - a) / 1e9 for n, a, b in self.events if fragment in n]


def start() -> profile:
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof: profile, start_ns: int, end_ns: int) -> DeviceTrace:
    """Stop the profiler and keep the card's events inside [start, end].
    Prints to standard error how long each step of the reading took."""
    t0 = time.perf_counter()
    prof.__exit__(None, None, None)
    t1 = time.perf_counter()
    raw = prof.profiler.kineto_results.events()
    t2 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    # PyTorch releases differ in which of these fields an event has.
    flagged = bool(raw) and hasattr(raw[0], "is_user_annotation")
    kinds = bool(raw) and hasattr(raw[0], "activity_type")
    events = []
    gc.disable()  # millions of small tuples: the collector would rescan them over and over
    try:
        for e in raw:
            if e.device_type() != cuda:
                continue
            name = e.name()
            # the device-side copies of the host's annotations are not work
            if name.startswith(SPAN_PREFIX) or (flagged and e.is_user_annotation()):
                continue
            if kinds and not any(a in e.activity_type() for a in DEVICE_ACTIVITIES):
                continue
            a = e.start_ns()
            b = min(a + e.duration_ns(), end_ns)
            a = max(a, start_ns)
            if b > a:
                events.append((name, a, b))
        busy = union(events)
    finally:
        gc.enable()
    t3 = time.perf_counter()
    print(f"trace: the profiler stopped in {t1 - t0:.1f} s, handed over {len(raw)} events in "
          f"{t2 - t1:.1f} s, reduced in {t3 - t2:.1f} s", file=sys.stderr)
    return DeviceTrace(start_ns, end_ns, events, busy)


def union(events) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for _, a, b in sorted(events, key=lambda x: x[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def top_device_ops(trace: DeviceTrace, n: int = TOP) -> list[list]:
    """The device operations that took most time, summed by name."""
    total: dict[str, int] = defaultdict(int)
    for name, a, b in trace.events:
        total[name] += b - a
    return [[name[:160], t / 1e9] for name, t in sorted(total.items(), key=lambda x: -x[1])[:n]]


def _innermost_timeline(spans: dict[str, list[tuple[int, int]]]) -> tuple[list[int], list[str]]:
    """Change points of the innermost open span: (times, labels), each
    label holding from its time to the next."""
    edges = []
    for label, ivs in spans.items():
        for a, b in ivs:
            edges.append((a, -b, label))
    edges.sort()  # by start; of two spans that start together, the outer first
    times, labels, stack = [], [], []
    # Spans nest (they follow the host's call stack), so a stack of open
    # spans, popped by end time, gives the innermost at every start.
    for a, neg_b, label in edges:
        b = -neg_b
        while stack and stack[-1][0] <= a:
            end, _ = stack.pop()
            times.append(end)
            labels.append(stack[-1][1] if stack else OUTSIDE)
        stack.append((b, label))
        times.append(a)
        labels.append(label)
    while stack:
        end, _ = stack.pop()
        times.append(end)
        labels.append(stack[-1][1] if stack else OUTSIDE)
    return times, labels


def idle_gaps_by_span(trace: DeviceTrace, spans: dict[str, list[tuple[int, int]]],
                      n: int = TOP) -> list[list]:
    """The card's idle time inside the window, summed by the innermost
    benchmark span open on the host when each gap began."""
    times, labels = _innermost_timeline(spans)
    total: dict[str, int] = defaultdict(int)
    t = trace.start_ns
    for a, b in trace.busy + [(trace.end_ns, trace.end_ns)]:
        if a > t:
            i = bisect.bisect_right(times, t) - 1
            total[labels[i] if i >= 0 else OUTSIDE] += a - t
        t = max(t, b)
    return [[label, s / 1e9] for label, s in sorted(total.items(), key=lambda x: -x[1])[:n]]
