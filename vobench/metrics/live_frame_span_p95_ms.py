"""The 95th percentile (nearest rank) of the program's `live.frame` request
spans (`vo/live.py`: from when a frame is taken off the stream to when its
output is yielded) that end inside the traced window, in ms. Keys, of the
frame at that rank, which sum to the value: `own_ms_p95`, its own `frame`
span (its upload, draws, frontend, step and keyframe stage), and
`held_ms_p95`, the rest (the next frame's work and the wait for its event);
`samples`, the number of spans it was taken over."""

import math

from vobench import program_spans

TRACE = True


def read(run):
    w = program_spans.window(run)
    reqs = [] if w is None else [r for r in w.requests if r.name == "live.frame"]
    if not reqs:
        return None
    own_spans: dict[int, list] = {}
    for s in w.spans.values():
        if s.name == "frame":
            own_spans.setdefault(s.attrs.get("frame"), []).append(s)
    rows = []
    for r in reqs:
        own = sum(s.end_ns - s.start_ns for s in own_spans.get(r.attrs["frame"], ())
                  if r.start_ns <= s.start_ns and s.end_ns <= r.end_ns)
        rows.append((r.end_ns - r.start_ns, own))
    rows.sort()
    total, own = rows[max(math.ceil(0.95 * len(rows)) - 1, 0)]
    return {"value": total / 1e6, "own_ms_p95": own / 1e6, "held_ms_p95": (total - own) / 1e6,
            "samples": len(rows)}
