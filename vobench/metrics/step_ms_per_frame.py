"""Host ms per frame in the per-frame step, `vo/pipeline.py:step_full` as
`vo/ba_pipeline.py` calls it, over the frames the window processed."""

SPANS = {"step": ["sosvo_torch.vo.ba_pipeline:step_full"]}


def read(run):
    s = run.recorder.seconds("step")
    if not s or run.frames_processed == 0:
        return None
    return 1e3 * sum(s) / run.frames_processed
