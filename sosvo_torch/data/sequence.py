"""Image sequences and trajectories on disk (counterpart of `sosvo/data/sequence.py`).

A staged sequence is one `.npz` bundle in the JAX package's layout:
`images` (F, H, W) float32 raw omni frames, `poses` (F, 4, 4) float32
world-from-rig ground truth (either may be absent) and `timestamps` (F,)
float64 seconds, so a bundle written by either package loads in the other.
Trajectories also go to and from TUM text (`t tx ty tz qx qy qz qw` per
line, six decimals), written byte for byte as the JAX package writes them.
Everything here is numpy: the caller moves frames to a device when it
needs them there.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from sosvo_torch.geom.lie import mat_to_quat, quat_to_mat


class Sequence(NamedTuple):
    images: np.ndarray | None   # (F, H, W) float32 raw omni frames (or None)
    poses: np.ndarray | None    # (F, 4, 4) float32 ground-truth world-from-rig (or None)
    timestamps: np.ndarray      # (F,) float64 seconds


def save_sequence(path: str | Path, images=None, poses=None, timestamps=None) -> None:
    """Write a compressed `.npz` bundle; timestamps default to 0, 1, ..."""
    f = images if images is not None else poses
    if f is None:
        raise ValueError("save_sequence needs images or poses")
    n = len(f)
    ts = np.arange(n, dtype=np.float64) if timestamps is None else np.asarray(timestamps)
    arrays = {"timestamps": ts}
    if images is not None:
        arrays["images"] = np.asarray(images, np.float32)
    if poses is not None:
        arrays["poses"] = np.asarray(poses, np.float32)
    np.savez_compressed(path, **arrays)


def load_sequence(path: str | Path) -> Sequence:
    with np.load(path) as z:
        return Sequence(images=z["images"] if "images" in z else None,
                        poses=z["poses"] if "poses" in z else None,
                        timestamps=z["timestamps"])


def save_tum_trajectory(path: str | Path, poses: np.ndarray, timestamps=None) -> None:
    """TUM format: `t tx ty tz qx qy qz qw` per line (world-from-rig); the
    quaternion is taken from the f32 rotation, w >= 0, normalised as the
    JAX package's writer does (`mat_to_quat(xla_rounding=True)`)."""
    poses = np.asarray(poses)
    n = poses.shape[0]
    ts = np.arange(n, dtype=np.float64) if timestamps is None else np.asarray(timestamps)
    R = torch.tensor(np.asarray(poses[:, :3, :3], np.float32))
    q = mat_to_quat(R, xla_rounding=True).numpy()  # wxyz
    with open(path, "w") as f:
        for i in range(n):
            t = poses[i, :3, 3]
            f.write(f"{ts[i]:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[i, 1]:.6f} {q[i, 2]:.6f} {q[i, 3]:.6f} {q[i, 0]:.6f}\n")


def load_tum_trajectory(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """(timestamps (F,), poses (F, 4, 4) float32); '#' lines are comments."""
    ts, poses = [], []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        v = [float(x) for x in line.split()]
        ts.append(v[0])
        T = np.eye(4, dtype=np.float32)
        # file order qx qy qz qw -> wxyz
        q = torch.tensor([v[7], v[4], v[5], v[6]], dtype=torch.float32)
        T[:3, :3] = quat_to_mat(q).numpy()
        T[:3, 3] = v[1:4]
        poses.append(T)
    return np.asarray(ts), np.stack(poses)
