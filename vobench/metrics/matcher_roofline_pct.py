"""The Hamming matcher kernel's share of its roofline bound.

The sum over the traced window's calls of the frozen bound
(`vobench/roofline.py:matcher_bound_ms` at each call's shape) over the sum
of the same calls' kernel time in the device trace. The calls are taken at
the program's launch wrapper, `kernels/match_cuda.py:match_stats_cuda`, one
kernel each; where the trace holds another number of kernels than there were
calls, the share is not read.
"""

import sys

from vobench import roofline

TRACE = True
KERNEL = "match_hamming_kernel"


def _shape(desc_a, desc_b, valid_a, valid_b, az_a=None, az_b=None, band=0.0):
    return desc_a.shape[0], desc_b.shape[0], band > 0.0


CALLS = {"matcher call": (["sosvo_torch.kernels.match_cuda:match_stats_cuda"], _shape)}


def read(run):
    if run.trace is None:
        return None
    calls = run.recorder.calls.get("matcher call", [])
    times = run.trace.kernel_seconds(KERNEL)
    if not calls or len(calls) != len(times):
        print(f"matcher_roofline_pct: {len(calls)} calls, {len(times)} {KERNEL} events: not read",
              file=sys.stderr)
        return None
    bound_s = sum(roofline.matcher_bound_ms(*c)[0] for c in calls) / 1e3
    return 100.0 * bound_s / sum(times)
