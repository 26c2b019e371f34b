"""Numerical sanitizers (counterpart of `sosvo/utils/debug.py`).

  * `checked(fn)`: `fn` whose outputs are checked: a NaN or Inf in any
    floating output tensor raises `FloatingPointError` naming where in the
    output it sits (the reference's `checkify` float checks, on the
    outputs: eager PyTorch has no traced program to instrument).
  * `strict_numerics()`: a context in which every torch operation is
    checked as it returns, and the first one that produces a NaN raises,
    naming the operation (the reference's `jax_debug_nans`; host-visible
    and slow: one read-back per operation). `checked` functions called in
    it are checked op by op too.
  * `library_solvers()`: the reference's switch from its hand-unrolled
    small Cholesky factorizations (`geometry/essential._chol9`,
    `align._chol4`) to the library's. The port's counterparts are the
    library's already (`geometry/essential.py` calls
    `torch.linalg.cholesky_ex`, `align.py` solves no linear system), so the
    switch changes no computation here: `UNROLLED_SOLVERS` is kept for
    code that reads the reference's flag, and nothing in the port reads it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable

import torch
from torch.overrides import TorchFunctionMode

# Consulted by nothing in the port (see the module docstring); flipped by
# `library_solvers` as the reference flips its own.
UNROLLED_SOLVERS = True


@contextlib.contextmanager
def library_solvers():
    """Context: the library's small-matrix solvers (the port's only ones)."""
    global UNROLLED_SOLVERS
    UNROLLED_SOLVERS = False
    try:
        yield
    finally:
        UNROLLED_SOLVERS = True


def _bad_leaves(x: Any, where: str, check: Callable[[torch.Tensor], torch.Tensor]):
    """(path, tensor) of every floating tensor in `x` (tensors, tuples,
    NamedTuples, lists, dicts) where `check` is true somewhere."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point() and bool(check(x).any()):
            yield where, x
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for name, v in zip(x._fields, x):
            yield from _bad_leaves(v, f"{where}.{name}", check)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _bad_leaves(v, f"{where}[{i}]", check)
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _bad_leaves(v, f"{where}[{k!r}]", check)


def checked(fn: Callable) -> Callable:
    """`fn`, raising FloatingPointError when any floating output tensor
    holds a NaN or an Inf (the message names each such output). Runs `fn`
    with the library solvers, as the reference's `checked` does.

    Usage:
        out = checked(step)(rig, cfg, state, obs)   # raises on NaN / Inf
    """
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with library_solvers():
            out = fn(*args, **kwargs)
        bad = [f"{where} ({int((~torch.isfinite(t)).sum())} of {t.numel()})"
               for where, t in _bad_leaves(out, "out", lambda t: ~torch.isfinite(t))]
        if bad:
            raise FloatingPointError(f"{getattr(fn, '__name__', fn)}: non-finite values in "
                                     + ", ".join(bad))
        return out

    return wrapped


class _NanCheck(TorchFunctionMode):
    """Checks every torch operation's floating outputs for NaN as it returns."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        bad = next(_bad_leaves(out, "out", torch.isnan), None)
        if bad is not None:
            raise FloatingPointError(f"NaN produced by {getattr(func, '__name__', func)} "
                                     f"({bad[0]})")
        return out


@contextlib.contextmanager
def strict_numerics():
    """Context: raise on the first torch operation that produces a NaN."""
    with _NanCheck():
        yield
