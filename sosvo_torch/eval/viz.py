"""Map and overlay artifacts (counterpart of `sosvo/eval/viz.py`, numpy only).

Host-side numpy and matplotlib, never on the compute path; matplotlib is
imported inside the functions that draw, so the module imports without it.

Artifacts:
  - `save_ply`          landmark map / triangulated points as ASCII PLY
                        (loads in MeshLab, CloudCompare, Open3D)
  - `plot_map_3d`       3D scatter of the landmark map + est/gt trajectories
  - `keypoint_overlay`  raw omni image + per-view detected keypoints
  - `match_overlay`     raw omni image + top<->bottom stereo match segments
                        (radial lines: epipolar curves of the coaxial rig)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_ply(path: str | Path, points: np.ndarray, colors: np.ndarray | None = None,
             valid: np.ndarray | None = None) -> int:
    """Write (N, 3) points (optionally masked / RGB-colored) as ASCII PLY.

    Returns the number of vertices written. `colors` is (N, 3) uint8 or
    float in [0, 1]; `valid` is an (N,) bool mask selecting live slots
    (fixed-shape pipelines carry dead slots -- don't export them).
    """
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if valid is not None:
        m = np.asarray(valid, bool).reshape(-1)
        pts = pts[m]
        if colors is not None:
            colors = np.asarray(colors).reshape(-1, 3)[m]
    n = pts.shape[0]
    lines = [
        "ply", "format ascii 1.0", f"element vertex {n}",
        "property float x", "property float y", "property float z",
    ]
    if colors is not None:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = np.clip(np.asarray(c, np.float64) * 255.0, 0, 255).astype(np.uint8)
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
        lines.append("end_header")
        for p, rgb in zip(pts, c):
            lines.append(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {rgb[0]} {rgb[1]} {rgb[2]}")
    else:
        lines.append("end_header")
        for p in pts:
            lines.append(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}")
    Path(path).write_text("\n".join(lines) + "\n")
    return n


def plot_map_3d(out_path: str | Path, traj_est: np.ndarray,
                landmarks: np.ndarray | None = None,
                lm_valid: np.ndarray | None = None,
                traj_gt: np.ndarray | None = None,
                title: str = "map + trajectory") -> None:
    """3D landmark map + trajectory view; trajectories are (F, 4, 4) poses."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    if landmarks is not None:
        lm = np.asarray(landmarks, np.float32).reshape(-1, 3)
        if lm_valid is not None:
            lm = lm[np.asarray(lm_valid, bool).reshape(-1)]
        if lm.shape[0]:
            ax.scatter(lm[:, 0], lm[:, 1], lm[:, 2], s=2, c=lm[:, 2],
                       cmap="viridis", alpha=0.5, label=f"landmarks ({lm.shape[0]})")
    e = np.asarray(traj_est)[:, :3, 3]
    ax.plot(e[:, 0], e[:, 1], e[:, 2], "-", color="tab:red", linewidth=2.0,
            label="estimate")
    if traj_gt is not None:
        g = np.asarray(traj_gt)[:, :3, 3]
        ax.plot(g[:, 0], g[:, 1], g[:, 2], "--", color="k", linewidth=1.2,
                label="ground truth")
    ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]"); ax.set_zlabel("z [m]")
    ax.legend(loc="upper left", fontsize=8)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def keypoint_overlay(out_path: str | Path, image: np.ndarray,
                     uv_top: np.ndarray, valid_top: np.ndarray,
                     uv_bottom: np.ndarray | None = None,
                     valid_bottom: np.ndarray | None = None,
                     title: str = "detected keypoints") -> None:
    """Raw omni image with detected keypoints per view (top red, bottom cyan)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.asarray(image), cmap="gray", interpolation="nearest")
    ut = np.asarray(uv_top)[np.asarray(valid_top, bool)]
    ax.scatter(ut[:, 0], ut[:, 1], s=8, facecolors="none", edgecolors="r",
               linewidths=0.7, label=f"top ({ut.shape[0]})")
    if uv_bottom is not None:
        vb = np.asarray(valid_bottom, bool)
        ub = np.asarray(uv_bottom)[vb]
        ax.scatter(ub[:, 0], ub[:, 1], s=8, facecolors="none", edgecolors="c",
                   linewidths=0.7, label=f"bottom ({ub.shape[0]})")
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def match_overlay(out_path: str | Path, image: np.ndarray,
                  uv_a: np.ndarray, uv_b: np.ndarray, mask: np.ndarray,
                  title: str = "stereo matches") -> None:
    """Raw omni image with line segments joining matched top/bottom pixels.

    On the coaxial rig the top/bottom epipolar curves are radial lines in
    the raw image, so correct stereo matches draw as near-radial segments --
    a one-glance sanity check the reference's viewers also provide.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    m = np.asarray(mask, bool)
    a = np.asarray(uv_a)[m]
    b = np.asarray(uv_b)[m]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.asarray(image), cmap="gray", interpolation="nearest")
    segs = np.stack([a, b], axis=1)  # (M, 2, 2)
    ax.add_collection(LineCollection(segs, colors="lime", linewidths=0.6, alpha=0.8))
    ax.scatter(a[:, 0], a[:, 1], s=4, c="r")
    ax.scatter(b[:, 0], b[:, 1], s=4, c="c")
    ax.set_title(f"{title} ({a.shape[0]})")
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
