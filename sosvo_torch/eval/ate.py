"""Trajectory evaluation: ATE and RPE, TUM-benchmark style (counterpart of
`sosvo/eval/ate.py`)."""

from __future__ import annotations

import torch

from sosvo_torch.geom.lie import geodesic_angle, mat_inv, norm
from sosvo_torch.geometry.align import umeyama


def ate_rmse(est_positions: torch.Tensor, gt_positions: torch.Tensor, with_scale: bool = False):
    """ATE RMSE (m) after a closed-form SE(3) (or Sim(3)) Horn alignment of
    the (F, 3) estimated positions onto ground truth -> (rmse, T_align)."""
    T, _ = umeyama(est_positions, gt_positions, with_scale=with_scale)
    aligned = est_positions @ T[:3, :3].T + T[:3, 3]
    err = aligned - gt_positions
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=-1))), T


def rpe(est_poses: torch.Tensor, gt_poses: torch.Tensor, delta: int = 1):
    """Relative pose error at frame spacing `delta` -> (trans_rmse, rot_rmse)."""
    rel_est = mat_inv(est_poses[:-delta]) @ est_poses[delta:]
    rel_gt = mat_inv(gt_poses[:-delta]) @ gt_poses[delta:]
    err = mat_inv(rel_gt) @ rel_est
    trans = norm(err[..., :3, 3])
    eye = torch.eye(3, dtype=err.dtype, device=err.device).expand(err[..., :3, :3].shape)
    rot = geodesic_angle(eye, err[..., :3, :3])
    return torch.sqrt(torch.mean(trans**2)), torch.sqrt(torch.mean(rot**2))
