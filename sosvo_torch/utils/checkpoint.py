"""Checkpoint and resume of a replay's state (counterpart of
`sosvo/utils/checkpoint.py`, with `torch.save` in place of orbax).

A state is any NamedTuple tree of tensors and `torch.Generator`s (a
`TrackState`, a `BAState`, their batched forms with a tuple of lane
generators). `save_state` writes its tensors in field order, moved to the
CPU, and every generator's `get_state()` to `<dir>/step_{n:08d}`;
`restore_state` loads it with `weights_only=True` into a template of the
same structure: tensors onto the template's devices (each must have the
template's shape and dtype: a SIFT state's float descriptor buffers do not
restore into a BRIEF template's int32 words, or back), and each template
generator `set_state` from the saved one. The random streams are
part of the state, so a replay resumed from step n equals the
uninterrupted one bit for bit.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch


def _leaves(tree: Any, tensors: list, generators: list) -> None:
    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
    elif isinstance(tree, torch.Generator):
        generators.append(tree)
    elif isinstance(tree, tuple):
        for x in tree:
            _leaves(x, tensors, generators)


def _rebuild(tree: Any, tensors) -> Any:
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(x, tensors) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_rebuild(x, tensors) for x in tree)
    return tree  # generators are restored in place


def _path(ckpt_dir: str | Path, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{step:08d}"


def save_state(ckpt_dir: str | Path, step: int, state: Any) -> Path:
    """Snapshot `state` at `step`; returns the checkpoint's path. The file
    appears whole or not at all (written beside it, then renamed)."""
    tensors, generators = [], []
    _leaves(state, tensors, generators)
    path = _path(ckpt_dir, step)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save({"tensors": [t.detach().cpu() for t in tensors],
                "generators": [g.get_state() for g in generators]}, tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str | Path) -> int | None:
    p = Path(ckpt_dir)
    if not p.exists():
        return None
    steps = sorted(int(f.name.split("_")[1]) for f in p.iterdir()
                   if f.name.startswith("step_") and f.name[5:].isdigit())
    return steps[-1] if steps else None


def restore_state(ckpt_dir: str | Path, step: int, template: Any) -> Any:
    """The state saved at `step`, shaped like `template`; the template's
    generators are set to the saved streams and belong to the result."""
    raw = torch.load(_path(ckpt_dir, step), weights_only=True)
    tensors, generators = [], []
    _leaves(template, tensors, generators)
    if len(raw["tensors"]) != len(tensors) or len(raw["generators"]) != len(generators):
        raise ValueError(f"checkpoint {_path(ckpt_dir, step)} does not fit the template: "
                         f"{len(raw['tensors'])} tensors and {len(raw['generators'])} generators "
                         f"saved, {len(tensors)} and {len(generators)} expected")
    restored = []
    for r, t in zip(raw["tensors"], tensors):
        if r.shape != t.shape or r.dtype != t.dtype:
            raise ValueError(f"checkpoint tensor {r.dtype} {tuple(r.shape)} where the template "
                             f"has {t.dtype} {tuple(t.shape)}")
        restored.append(r.to(device=t.device))
    for r, g in zip(raw["generators"], generators):
        g.set_state(r)
    return _rebuild(template, iter(restored))
