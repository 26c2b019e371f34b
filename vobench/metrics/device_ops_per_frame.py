"""Device operations per frame: the device trace's events (kernels, copies,
fills) inside the traced window over the frames stepped in it (the
program's `step` spans), with the same count by the innermost program span
open on the host when each operation began on the card, and `outside` for
those that began with no span open; the keys sum to the value. The value
is an exact count that does not follow the host's speed. The keys place
each operation by when it began on the card, not by the span that launched
it, so where the card falls behind the host an operation lands under a
later span and the split blurs."""

import sys

from vobench import program_spans

TRACE = True


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    n = len(run.trace.events)
    print(f"device_ops_per_frame: {n} device events over {w.frames} frames", file=sys.stderr)
    return {"value": n / w.frames, **{k: c / w.frames for k, c in w.ops.items()}}
