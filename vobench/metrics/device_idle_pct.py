"""The share of the traced window in which nothing ran on the card: 100 %
less the union of the kernel, copy and fill intervals of the device trace,
over the window."""

TRACE = True


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.events:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
