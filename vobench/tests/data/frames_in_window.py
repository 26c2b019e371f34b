"""A made-up metric for the harness's tests: the frames the window processed."""


def read(run):
    return run.frames_processed
