"""Host ms per frame in the program's `frontend` spans
(`frontend/image_frontend.py`: `extract_sequence` in a replay,
`extract_observations` frame by frame in a live session) inside the traced
window, over the frames stepped in it. Keys: ms per frame in each child
span (`frontend.warp`, `frontend.detect`, `frontend.describe`,
`frontend.lift`) and `self`, which sum to the value, and `idle.<part>`, the
card's idle ms per frame inside each of those parts."""

from vobench import program_spans

TRACE = True


def read(run):
    w = program_spans.window(run)
    return None if w is None else w.stage("frontend", w.frames, 1e6)
