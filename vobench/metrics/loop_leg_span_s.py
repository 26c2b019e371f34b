"""Host seconds per loop leg: the program's `loop_leg` spans
(`vo/loop_closure.py:close_loops`) inside the traced window, per span.
Keys: seconds per leg in each child span (`loop_leg.features`,
`loop_leg.candidates`, `loop_leg.pairs`, `loop_leg.pgo`,
`loop_leg.correct`) and `self`, which sum to the value; `idle_s`, the
card's idle seconds per leg inside the spans; `pairs_tried`, the candidate
pairs evaluated per leg (`loop.pairs_tried`)."""

from vobench import program_spans

TRACE = True


def read(run):
    w = program_spans.window(run)
    legs = 0 if w is None else sum(1 for s in w.spans.values() if s.name == "loop_leg")
    if not legs:
        return None
    parts = w.stage("loop_leg", legs, 1e9)
    out = {k: v for k, v in parts.items() if not k.startswith("idle.")}
    out["idle_s"] = sum(v for k, v in parts.items() if k.startswith("idle."))
    out["pairs_tried"] = w.counts_under("loop_leg").get("loop.pairs_tried", 0) / legs
    return out
