"""Host ms per window solve: the program's `keyframe.window_ba` spans
(`vo/ba_pipeline.py:keyframe_stage` around `vo/keyframes.py:run_window_ba`)
inside the traced window, per span. Keys: ms per solve in `ba.build`,
`ba.schur` and `ba.solve` (`backend/ba.py:lm_step`, every LM iteration's)
and `self`, which sum to the value; `idle_ms`, the card's idle ms per solve
inside the spans; `lm_iters_per_solve`, the `ba.lm_iters` count per solve;
`keyframes_per_frame` and `reloc_tried_per_frame`, the keyframe stage's
`keyframes` and `reloc.tried` counts over the frames stepped in the window.
The last four sit beside the parts and are not among them."""

from vobench import program_spans

TRACE = True


def read(run):
    w = program_spans.window(run)
    solves = 0 if w is None else sum(1 for s in w.spans.values()
                                     if s.name == "keyframe.window_ba")
    if not solves:
        return None
    parts = w.stage("keyframe.window_ba", solves, 1e6)
    out = {k: v for k, v in parts.items() if not k.startswith("idle.")}
    out["idle_ms"] = sum(v for k, v in parts.items() if k.startswith("idle."))
    out["lm_iters_per_solve"] = w.counts_under("keyframe.window_ba").get("ba.lm_iters", 0) / solves
    out["keyframes_per_frame"] = w.count("keyframes") / w.frames
    out["reloc_tried_per_frame"] = w.count("reloc.tried") / w.frames
    return out
