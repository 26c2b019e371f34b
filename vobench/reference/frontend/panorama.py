"""Cylindrical panorama generation from the raw omni image (counterpart of
`sosvo/frontend/panorama.py`).

Rows sample elevation linearly in [min_el, max_el] (top row = max
elevation), columns sample azimuth uniformly over [-pi, pi). The two views
are coaxial, so one column of the top and of the bottom panorama is one
azimuth: stereo matching searches along columns. The panorama wraps
horizontally.

The sampling LUT is built once per (rig, panorama geometry); the per-frame
warp is a bilinear gather. The reference lays the raw image out as 2x2
quad tables so that each panorama pixel costs one TPU gather index; that
layout exists only for the TPU's per-index gather cost. Here the warp
gathers the four corners of the clamped (v0, u0) cell directly, with the
reference's lerp order, so on the same LUT it gives the same bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vobench.reference.sensor.model import ViewParams, project


class PanoGeometry(NamedTuple):
    """Static panorama geometry and the precomputed sampling LUT of one view."""

    height: int
    width: int
    min_elevation: float
    max_elevation: float
    lut_uv: torch.Tensor  # (H, W, 2) raw-image (u, v) sample coords
    valid: torch.Tensor   # (H, W) bool: the LUT lands inside the view's annulus
    u0: torch.Tensor      # (H, W) int64 column of the bilinear cell's top-left corner
    v0: torch.Tensor      # (H, W) int64 row of that corner
    fu: torch.Tensor      # (H, W) f32 horizontal lerp fraction
    fv: torch.Tensor      # (H, W) f32 vertical lerp fraction


def pano_azimuth(width: int, col: torch.Tensor) -> torch.Tensor:
    return (col + 0.5) / width * (2.0 * math.pi) - math.pi


def pano_elevation(height: int, min_el: float, max_el: float, row: torch.Tensor) -> torch.Tensor:
    return max_el - (row + 0.5) / height * (max_el - min_el)


def pano_ray(height: int, width: int, min_el: float, max_el: float,
             row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Unit ray (view frame) of a panorama pixel; row/col may be fractional."""
    az = pano_azimuth(width, col)
    el = pano_elevation(height, min_el, max_el, row)
    cos_el = torch.cos(el)
    return torch.stack([cos_el * torch.cos(az), cos_el * torch.sin(az), torch.sin(el)], dim=-1)


def build_pano_geometry(view: ViewParams, height: int, width: int,
                        min_el: float | None = None, max_el: float | None = None,
                        image_height: int = 768, image_width: int = 768) -> PanoGeometry:
    """The sampling LUT mapping panorama pixels to raw-image coordinates, on
    the view's device; run once per calibration."""
    min_el = float(view.min_elevation) if min_el is None else min_el
    max_el = float(view.max_elevation) if max_el is None else max_el
    device = view.fx.device
    rows = torch.arange(height, dtype=torch.float32, device=device)
    cols = torch.arange(width, dtype=torch.float32, device=device)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    uv, ok = project(view, pano_ray(height, width, min_el, max_el, rr, cc))
    # Clamp to the image so the cell's +1 corners always exist.
    u = torch.clamp(uv[..., 0], 0.0, image_width - 1.001)
    v = torch.clamp(uv[..., 1], 0.0, image_height - 1.001)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    return PanoGeometry(height=height, width=width, min_elevation=min_el, max_elevation=max_el,
                        lut_uv=uv, valid=ok, u0=u0.to(torch.int64), v0=v0.to(torch.int64),
                        fu=u - u0, fv=v - v0)


def warp_panorama(image: torch.Tensor, geom: PanoGeometry) -> torch.Tensor:
    """Bilinear-sample the raw omni image into the panorama: (H, W) f32."""
    w = image.shape[1]
    flat = image.reshape(-1)
    i00 = geom.v0 * w + geom.u0
    q00, q01 = flat[i00], flat[i00 + 1]
    q10, q11 = flat[i00 + w], flat[i00 + w + 1]
    v0 = q00 * (1.0 - geom.fu) + q01 * geom.fu
    v1 = q10 * (1.0 - geom.fu) + q11 * geom.fu
    pano = v0 * (1.0 - geom.fv) + v1 * geom.fv
    return torch.where(geom.valid, pano, 0.0)
