"""Spans and counters of the pipeline's stages, kept in memory; off by default.

    from sosvo_torch.utils import spans
    spans.enable()
    ...                                   # a replay, a live session, a loop leg
    for s in spans.spans():               # nested stages, in the order they opened
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms", s.attrs, s.counts)
    frames = spans.requests()             # `live.frame`: each frame from take to output
    spans.disable()
    spans.reset()

A span is one stage of the work: its name, its start and end on
`time.time_ns()` (the base of torch.profiler's device timestamps, so the
card's activity can be laid under the stage open on the host at the time),
the index of the span it opened inside (-1: none), the host int `frame`
naming the frame it worked on (spans opened inside it inherit it), and the
counts `count()` added while it was the innermost open span. A count with no
span open is not kept. Counters named `sync.<site>` count the host's
reads of the card at each site.

A request span (`begin`/`end`, keyed) follows one frame across other work,
such as the next frame's step, and stays out of the nesting. Spans are
recorded from one thread. When tracing is off, `span()` returns one shared
null context after a single check, and `count()`, `begin()` and `end()` do
nothing: no clock is read and nothing is allocated.
"""

from __future__ import annotations

import time


class Span:
    """One recorded stage; also its own context manager while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs", "counts")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.start_ns = self.end_ns = 0
        self.parent = -1
        self.attrs = attrs
        self.counts: dict[str, int] = {}

    def __enter__(self):
        stack = _T.stack
        if stack:
            self.parent = stack[-1]
            if "frame" not in self.attrs:
                frame = _T.spans[self.parent].attrs.get("frame")
                if frame is not None:
                    self.attrs["frame"] = frame
        stack.append(len(_T.spans))
        _T.spans.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if _T.stack:  # empty only after a reset() inside the span
            _T.stack.pop()
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _Tracer:
    def __init__(self):
        self.on = False
        self.spans: list[Span] = []
        self.stack: list[int] = []
        self.open: dict[tuple[str, int], Span] = {}
        self.requests: list[Span] = []


_T = _Tracer()
_NULL = _Null()


def enable() -> None:
    _T.on = True


def disable() -> None:
    _T.on = False


def reset() -> None:
    """Forget every span and request (open ones too)."""
    _T.spans, _T.stack, _T.open, _T.requests = [], [], {}, []


def span(name: str, frame: int | None = None):
    """A context manager recording the stage `name` when tracing is on."""
    if not _T.on:
        return _NULL
    return Span(name, {} if frame is None else {"frame": frame})


def count(name: str, n: int = 1) -> None:
    """Add `n` (a host int) to `name` on the innermost open span."""
    if not _T.on or not _T.stack:
        return
    counts = _T.spans[_T.stack[-1]].counts
    counts[name] = counts.get(name, 0) + n


def begin(name: str, key: int) -> None:
    """Open the request span `name` for `key` (its `frame` attr)."""
    if not _T.on:
        return
    s = Span(name, {"frame": key})
    s.start_ns = time.time_ns()
    _T.open[(name, key)] = s


def end(name: str, key: int) -> None:
    """Close the request span `name` for `key`, if one is open."""
    if not _T.on:
        return
    s = _T.open.pop((name, key), None)
    if s is not None:
        s.end_ns = time.time_ns()
        _T.requests.append(s)


def spans() -> list[Span]:
    """The nested spans recorded so far, in the order they opened (a span's
    `parent` indexes this list); a span still open has `end_ns` 0."""
    return _T.spans


def requests() -> list[Span]:
    """The request spans closed so far, in the order they closed."""
    return _T.requests
