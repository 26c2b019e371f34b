"""Trajectory and per-frame plots (counterpart of `sosvo/eval/plots.py`,
numpy only; matplotlib is imported inside the functions that draw)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def plot_trajectories(est: np.ndarray, gt: np.ndarray | None, out_path: str | Path,
                      title: str = "trajectory") -> None:
    """Top-down (x, y) trajectory plot; est/gt are (F, 4, 4) pose arrays."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    e = np.asarray(est)[:, :3, 3]
    ax.plot(e[:, 0], e[:, 1], "-", label="estimate", linewidth=1.5)
    if gt is not None:
        g = np.asarray(gt)[:, :3, 3]
        ax.plot(g[:, 0], g[:, 1], "--", label="ground truth", linewidth=1.2)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_frame_stats(rows: list[dict], out_path: str | Path) -> None:
    """Per-frame counts/inliers from the JSONL log rows."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    f = [r["frame"] for r in rows]
    fig, ax = plt.subplots(figsize=(8, 3))
    for k in ("n_stereo", "n_temporal", "n_inliers"):
        ax.plot(f, [r[k] for r in rows], label=k, linewidth=1.0)
    ax.set_xlabel("frame")
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
