"""Omnidirectional camera model (unified catadioptric / GUM) on tensors.

Counterpart of `sosvo/sensor/model.py`; see that module for the model's
derivation. Projection: misalignment rotation, lift to the unit sphere,
perspective from the sphere centre + xi, radial/tangential distortion,
intrinsics. Unprojection inverts it in closed form with a fixed-point
undistort of UNDISTORT_ITERS steps (exact when distortion is zero).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.geom.lie import norm
from vobench.reference.utils.device import resolve

UNDISTORT_ITERS = 8  # fixed-point iterations; exact when distortion is zero


class ViewParams(NamedTuple):
    """Calibrated parameters of one catadioptric view, as 0-d f32 tensors on
    one device. Field meanings as in `sosvo.sensor.model.ViewParams`."""

    xi: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    min_elevation: torch.Tensor
    max_elevation: torch.Tensor
    z_offset: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    mis_rx: torch.Tensor
    mis_ry: torch.Tensor

    @staticmethod
    def create(xi, fx, fy, cx, cy, min_elevation, max_elevation, z_offset=0.0,
               k1=0.0, k2=0.0, p1=0.0, p2=0.0, mis_rx=0.0, mis_ry=0.0,
               device: torch.device | str | None = None) -> "ViewParams":
        device = resolve(device)
        vals = (xi, fx, fy, cx, cy, min_elevation, max_elevation, z_offset,
                k1, k2, p1, p2, mis_rx, mis_ry)
        return ViewParams(*(torch.as_tensor(v, dtype=torch.float32, device=device)
                            for v in vals))


def viewpoint(view: ViewParams) -> torch.Tensor:
    """The view's effective viewpoint (single effective focus) in rig frame."""
    z = view.z_offset
    zero = torch.zeros_like(z)
    return torch.stack([zero, zero, z], dim=-1)


def _mis_rotation(view: ViewParams) -> torch.Tensor:
    """(3, 3) rotation taking mirror-frame vectors to the view frame.

    Rodrigues on the axis (mis_rx, mis_ry, 0) with Taylor guards near zero.
    """
    rx, ry = view.mis_rx, view.mis_ry
    th2 = rx * rx + ry * ry
    th = torch.sqrt(th2)
    small = th < 1e-5
    one = torch.ones_like(th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / torch.where(small, one, th))
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th)) / torch.where(small, one, th2))
    zero = torch.zeros_like(rx)
    K = torch.stack([
        torch.stack([zero, zero, ry], dim=-1),
        torch.stack([zero, zero, -rx], dim=-1),
        torch.stack([-ry, rx, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def _distort(view: ViewParams, mx: torch.Tensor, my: torch.Tensor):
    """Radial (k1, k2) + tangential (p1, p2) distortion on the normalized plane."""
    r2 = mx * mx + my * my
    rad = 1.0 + r2 * (view.k1 + r2 * view.k2)
    dx = 2.0 * view.p1 * mx * my + view.p2 * (r2 + 2.0 * mx * mx)
    dy = view.p1 * (r2 + 2.0 * my * my) + 2.0 * view.p2 * mx * my
    return rad * mx + dx, rad * my + dy


def _undistort(view: ViewParams, mdx: torch.Tensor, mdy: torch.Tensor):
    """Fixed-point inverse of `_distort` (UNDISTORT_ITERS steps)."""
    mx, my = mdx, mdy
    for _ in range(UNDISTORT_ITERS):
        r2 = mx * mx + my * my
        rad = 1.0 + r2 * (view.k1 + r2 * view.k2)
        dx = 2.0 * view.p1 * mx * my + view.p2 * (r2 + 2.0 * mx * mx)
        dy = view.p1 * (r2 + 2.0 * my * my) + 2.0 * view.p2 * mx * my
        mx = (mdx - dx) / rad
        my = (mdy - dy) / rad
    return mx, my


def project(view: ViewParams, pts_view: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Project (..., 3) view-frame points to (..., 2) pixels + (...,) validity."""
    R_mis = _mis_rotation(view)
    pts_m = pts_view @ R_mis            # R_mis^T @ p, batched over rows
    nrm = norm(pts_m, keepdim=True)
    s = pts_m / torch.clamp_min(nrm, 1e-9)
    denom = s[..., 2] + view.xi
    safe = denom > 1e-6
    denom_safe = torch.where(safe, denom, torch.ones_like(denom))
    mx = s[..., 0] / denom_safe
    my = s[..., 1] / denom_safe
    mx, my = _distort(view, mx, my)
    u = view.fx * mx + view.cx
    v = view.fy * my + view.cy
    elevation = torch.arcsin(torch.clamp(s[..., 2], -1.0, 1.0))
    valid = (safe
             & (elevation >= view.min_elevation)
             & (elevation <= view.max_elevation)
             & (nrm[..., 0] > 1e-6))
    return torch.stack([u, v], dim=-1), valid


def lift(view: ViewParams, uv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Lift (..., 2) pixels to (..., 3) unit rays in the view frame + validity."""
    mx = (uv[..., 0] - view.cx) / view.fx
    my = (uv[..., 1] - view.cy) / view.fy
    mx, my = _undistort(view, mx, my)
    r2 = mx * mx + my * my
    disc = 1.0 + (1.0 - view.xi * view.xi) * r2
    eta = (view.xi + torch.sqrt(torch.clamp_min(disc, 0.0))) / (r2 + 1.0)
    ray = torch.stack([eta * mx, eta * my, eta - view.xi], dim=-1)
    ray = ray / torch.clamp_min(norm(ray, keepdim=True), 1e-9)
    # Elevation gating happens in the MIRROR frame (where the annulus is
    # defined); the returned ray is rotated back into the view frame.
    elevation = torch.arcsin(torch.clamp(ray[..., 2], -1.0, 1.0))
    valid = (elevation >= view.min_elevation) & (elevation <= view.max_elevation) & (disc > 0.0)
    ray = ray @ _mis_rotation(view).T   # R_mis @ ray, batched over rows
    return ray, valid


def radius_of_elevation(view: ViewParams, elevation: torch.Tensor) -> torch.Tensor:
    """Image radius (pixels, isotropic f = fx) of a ray at the given elevation."""
    return view.fx * torch.cos(elevation) / (torch.sin(elevation) + view.xi)


def annulus_bounds(view: ViewParams) -> tuple[torch.Tensor, torch.Tensor]:
    """(r_inner, r_outer) pixel radii of this view's valid annulus (radius
    falls with elevation: r_inner is max_elevation's, r_outer min_elevation's)."""
    r_hi = radius_of_elevation(view, view.max_elevation)
    r_lo = radius_of_elevation(view, view.min_elevation)
    return torch.minimum(r_hi, r_lo), torch.maximum(r_hi, r_lo)


def annulus_mask(view: ViewParams, height: int, width: int) -> torch.Tensor:
    """Boolean (H, W) mask of the view's valid annulus in the raw image."""
    r_in, r_out = annulus_bounds(view)
    device = view.fx.device
    vv = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    uu = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    r = torch.sqrt((uu - view.cx) ** 2 + (vv - view.cy) ** 2)
    return (r >= r_in) & (r <= r_out)
