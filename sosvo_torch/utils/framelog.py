"""Per-frame JSONL logging (counterpart of `sosvo/utils/framelog.py`).

Every replay of the command line writes one JSON object per frame: frame
index, position, match and inlier counts, pose_ok. Same keys and rounding
as the JAX package's log, so two runs' logs compare line by line. Inputs
may be numpy arrays or tensors on any device (read through `.cpu()`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def stepoutput_rows(outs: Any, t_offset: int = 0) -> list[dict]:
    """Stacked StepOutput (leading frame axis) -> list of JSONL row dicts."""
    T = _np(outs.T_world)
    n_stereo, n_temporal = _np(outs.n_stereo), _np(outs.n_temporal)
    n_inliers, pose_ok = _np(outs.n_inliers), _np(outs.pose_ok)
    return [{
        "frame": int(f + t_offset),
        "pos": [round(float(x), 6) for x in T[f, :3, 3]],
        "n_stereo": int(n_stereo[f]),
        "n_temporal": int(n_temporal[f]),
        "n_inliers": int(n_inliers[f]),
        "pose_ok": bool(pose_ok[f]),
    } for f in range(T.shape[0])]


def write_jsonl(path: str | Path, rows: list[dict], append: bool = False) -> None:
    with open(path, "a" if append else "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def read_jsonl(path: str | Path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
