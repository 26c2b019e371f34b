"""Profiling and speed-of-light accounting (counterpart of `sosvo/utils/profiling.py`).

  * `trace(logdir)`: `torch.profiler` over the enclosed block (the card's
    kernels too where there is one), written to `logdir` as a Chrome trace
    (open it in Perfetto or chrome://tracing) with a table of operators;
  * `time_jitted(fn, *args)`: median wall seconds of one call, after a
    warm-up, with `torch.cuda.synchronize()` before and after each;
  * `time_amortized(fn, x)`: median per-call seconds of `inner` calls run
    back to back between two synchronizations, for calls too short to time
    one by one;
  * `roofline_matcher`, `roofline_schur`: the least time an H100 could take
    for each kernel's work, from `tools/bounds.py`'s work counts and rates.
"""

from __future__ import annotations

import contextlib
import statistics
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch

from sosvo_torch.tools import bounds


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str | Path | None = None):
    """Profile the enclosed block into `logdir` (default: `sosvo_torch_trace`
    under the temporary directory); yields the directory. Writes
    `trace.json` and `ops.txt` (operators by device time where there is a
    card, else by host time)."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir or Path(tempfile.gettempdir()) / "sosvo_torch_trace")
    logdir.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        try:
            yield logdir
        finally:
            _sync()
    prof.export_chrome_trace(str(logdir / "trace.json"))
    key = "cuda_time_total" if cuda else "cpu_time_total"
    (logdir / "ops.txt").write_text(prof.key_averages().table(sort_by=key, row_limit=50))


def time_jitted(fn: Callable, *args, n: int = 10, warmup: int = 1) -> float:
    """Median wall seconds of `fn(*args)`, synchronized, after `warmup` calls."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    ts = []
    for _ in range(n):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def time_amortized(fn: Callable, x, inner: int = 16, n: int = 5) -> float:
    """Median per-call seconds of `fn(x)`: `inner` calls back to back with no
    synchronization between them, timed between two synchronizations, `n`
    times (after one warm-up round). Eager calls are not hoisted or fused,
    so the calls need no data dependency between them."""
    def run():
        for _ in range(inner):
            fn(x)

    return time_jitted(run, n=n, warmup=1) / inner


def roofline_matcher(ka: int, kb: int, band: bool = True) -> dict:
    """Speed-of-light of one Hamming-match statistics call at ka x kb on the
    H100 (`tools/bounds.py`): operations 2 ka kb 256 at the tensor-core
    rate, bytes the descriptors, validity (and azimuths in the band) in and
    the per-row and per-column statistics out. The unfused ("xla") form
    also writes and reads the f32 (ka, kb) distance matrix once each."""
    n_bytes, ops = bounds.matcher_work(ka, kb, band)
    bytes_xla = n_bytes + 2 * 4.0 * ka * kb
    t_compute = ops / bounds.MATCHER_OP_PER_S
    return {
        "ops": ops,
        "bytes_fused": n_bytes,
        "t_compute_s": t_compute,
        "t_mem_fused_s": n_bytes / bounds.HBM_BYTES_PER_S,
        "t_mem_xla_s": bytes_xla / bounds.HBM_BYTES_PER_S,
        "sol_fused_s": max(t_compute, n_bytes / bounds.HBM_BYTES_PER_S),
        "sol_xla_s": max(t_compute, bytes_xla / bounds.HBM_BYTES_PER_S),
        "bound_ms": bounds.matcher_bound_ms(ka, kb, band)[0],
    }


def roofline_schur(W: int, L: int) -> dict:
    """Speed-of-light of one Schur reduction of a W x L window on the H100
    (`tools/bounds.py`): f32 operations at the f32 rate, bytes of its
    inputs and outputs at the HBM rate."""
    n_bytes, flops = bounds.schur_work(W, L)
    t_compute, t_mem = flops / bounds.F32_FLOP_PER_S, n_bytes / bounds.HBM_BYTES_PER_S
    return {"flops": flops, "bytes": n_bytes, "t_compute_s": t_compute, "t_mem_s": t_mem,
            "sol_s": max(t_compute, t_mem), "bound_ms": bounds.schur_bound_ms(W, L)[0]}
