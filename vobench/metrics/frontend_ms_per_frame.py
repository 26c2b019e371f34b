"""Host ms per frame in the image frontend: the spans of
`frontend/image_frontend.py:extract_sequence` (the replay extracts a pass at
once) and of `extract_observations` as `vo/image_pipeline.py` calls it (the
live driver, frame by frame), over the frames the window processed."""

SPANS = {"frontend": ["sosvo_torch.frontend.image_frontend:extract_sequence",
                      "sosvo_torch.vo.image_pipeline:extract_observations"]}


def read(run):
    s = run.recorder.seconds("frontend")
    if not s or run.frames_processed == 0:
        return None
    return 1e3 * sum(s) / run.frames_processed
