"""Host ms per window solve in the keyframe stage,
`vo/keyframes.py:run_window_ba` as `vo/ba_pipeline.py` calls it."""

SPANS = {"window BA": ["sosvo_torch.vo.ba_pipeline:run_window_ba"]}


def read(run):
    s = run.recorder.seconds("window BA")
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
