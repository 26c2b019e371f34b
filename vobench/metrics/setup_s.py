"""Seconds from the process's start to the first timed frame: imports,
the inputs made from the seed, the program's set-up (the frontend's lookup
tables), the kernels' build where the checkout has none, and the warm-up."""


def read(run):
    return run.setup_s
