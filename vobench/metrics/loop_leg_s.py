"""Host seconds per loop leg, `vo/loop_closure.py:close_loops` (keyframe
features, candidate pairs, pair RANSAC and two-frame BA, DCS pose-graph
optimisation, the corrected trajectory)."""

SPANS = {"loop leg": ["sosvo_torch.vo.loop_closure:close_loops"]}


def read(run):
    s = run.recorder.seconds("loop leg")
    if not s:
        return None
    return sum(s) / len(s)
