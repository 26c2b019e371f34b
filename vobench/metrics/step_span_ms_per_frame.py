"""Host ms per frame in the program's `step` spans (`vo/pipeline.py:
step_full`) inside the traced window, over the frames stepped in it. Keys:
ms per frame in each child span (`step.stereo`, `step.temporal`,
`step.rigid`, `step.refine`, `step.gate`) and `self`, which sum to the
value, and `idle.<part>`, the card's idle ms per frame inside each of those
parts; `gate_fired_per_frame`, the frames on which the essential gate ran
its RANSAC (`gate.fired`) over the frames, beside the parts."""

from vobench import program_spans

TRACE = True


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    out = w.stage("step", w.frames, 1e6)
    out["gate_fired_per_frame"] = w.count("gate.fired") / w.frames
    return out
