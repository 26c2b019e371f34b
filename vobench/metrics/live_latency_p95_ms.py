"""The 95th percentile over every frame delivered inside the window of the
time from the frame's hand-over to the live driver to its output, in ms,
with the number of frames it was taken over."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return {"value": float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95)),
            "samples": len(run.latencies_s)}
