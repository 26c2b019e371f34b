"""Trajectory evaluation: ATE, TUM-benchmark style (counterpart of
`sosvo/eval/ate.py`)."""

from __future__ import annotations

import torch

from vobench.reference.geometry.align import umeyama


def ate_rmse(est_positions: torch.Tensor, gt_positions: torch.Tensor, with_scale: bool = False):
    """ATE RMSE (m) after a closed-form SE(3) (or Sim(3)) Horn alignment of
    the (F, 3) estimated positions onto ground truth -> (rmse, T_align)."""
    T, _ = umeyama(est_positions, gt_positions, with_scale=with_scale)
    aligned = est_positions @ T[:3, :3].T + T[:3, 3]
    err = aligned - gt_positions
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=-1))), T
