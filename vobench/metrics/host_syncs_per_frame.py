"""The program's synchronising calls per frame: PyTorch's sync debug mode
("warn") over the window, as the program's `tools/sync_check.py` counts them,
leaving out the benchmark's own, over the frames the window processed."""

SYNCS = True


def read(run):
    if run.syncs is None or run.frames_processed == 0:
        return None
    return run.syncs / run.frames_processed
