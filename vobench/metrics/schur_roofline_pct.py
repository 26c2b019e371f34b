"""The Schur reduction kernel's share of its roofline bound.

The sum over the traced window's calls of the frozen bound
(`vobench/roofline.py:schur_bound_ms` at each call's W x L) over the sum of
the same calls' kernel time in the device trace. The calls are taken at the
program's launch wrapper, `kernels/schur_cuda.py:schur_reduce_cuda`, one
kernel each; where the trace holds another number of kernels than there were
calls, the share is not read.
"""

import sys

from vobench import roofline

TRACE = True
KERNEL = "schur_cluster_kernel"


def _shape(H_cc, H_cl, *a, **k):
    return H_cl.shape[0], H_cl.shape[1]


CALLS = {"schur call": (["sosvo_torch.kernels.schur_cuda:schur_reduce_cuda"], _shape)}


def read(run):
    if run.trace is None:
        return None
    calls = run.recorder.calls.get("schur call", [])
    times = run.trace.kernel_seconds(KERNEL)
    if not calls or len(calls) != len(times):
        print(f"schur_roofline_pct: {len(calls)} calls, {len(times)} {KERNEL} events: not read",
              file=sys.stderr)
        return None
    bound_s = sum(roofline.schur_bound_ms(*c)[0] for c in calls) / 1e3
    return 100.0 * bound_s / sum(times)
