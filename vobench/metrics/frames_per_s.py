"""Frames completed over the time they took, on the host clock.

Replay: the frames of every pass that ended inside the window, over the time
from the window's start to the end of the last such pass (a pass's loop leg
included). Live: the frames whose output arrived inside the window, over the
window.
"""


def read(run):
    if run.frames == 0 or run.measured_s <= 0:
        return None
    return run.frames / run.measured_s
