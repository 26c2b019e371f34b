"""Omnistereo triangulation: midpoint of the common perpendicular, batched.

Counterpart of `sosvo/geometry/triangulate.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.geom.lie import norm


class TriangulationResult(NamedTuple):
    points: torch.Tensor     # (..., 3) rig-frame 3D points
    depth_top: torch.Tensor  # (...,) range along the top ray
    angle: torch.Tensor      # (...,) ray-ray angle (radians)
    gap: torch.Tensor        # (...,) distance between the two closest ray points
    valid: torch.Tensor      # (...,) bool: positive depths + gating thresholds


def midpoint_triangulate(ray_top: torch.Tensor, ray_bottom: torch.Tensor,
                         c_top: torch.Tensor, c_bottom: torch.Tensor,
                         min_angle: float = 0.004, max_range: float = 50.0,
                         max_gap: float = 0.08) -> TriangulationResult:
    """Midpoint of the common perpendicular between two (skew) unit rays.

    min_{s,t} |(c1 + s r1) - (c2 + t r2)|^2 in closed form, with
    b = r1.r2, d = r1.(c1-c2), e = r2.(c1-c2). Gated on positive depths,
    range, ray-ray angle and closest-approach gap.
    """
    r1, r2 = ray_top, ray_bottom
    dc = c_top - c_bottom
    b = torch.sum(r1 * r2, dim=-1)
    d = torch.sum(r1 * dc, dim=-1)
    e = torch.sum(r2 * dc, dim=-1)
    denom = 1.0 - b * b
    denom_safe = torch.clamp_min(denom, 1e-9)
    s = (b * e - d) / denom_safe
    t = (e - b * d) / denom_safe
    p1 = c_top + s[..., None] * r1
    p2 = c_bottom + t[..., None] * r2
    mid = 0.5 * (p1 + p2)
    gap = norm(p1 - p2)
    angle = torch.arccos(torch.clamp(b, -1.0, 1.0))
    valid = ((s > 1e-3) & (t > 1e-3) & (s < max_range) & (angle > min_angle)
             & (gap < max_gap) & (denom > 1e-9))
    return TriangulationResult(points=mid, depth_top=s, angle=angle, gap=gap, valid=valid)
