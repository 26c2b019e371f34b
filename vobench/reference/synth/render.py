"""Procedural raw-omni-image renderer (counterpart of `sosvo/synth/render.py`).

The scene is an analytically intersectable textured room (cylinder wall,
floor and ceiling with a hash-based value-noise texture and a faint
checker), ray-cast through the same sensor model the pipeline uses, so every
rendered image comes with exact ground truth. The raw image holds both
annular views, as the physical sensor does: each pixel inside a view's
annulus is lifted through that view to a rig-frame ray from its viewpoint,
moved by the ground-truth pose and intersected with the room.

Differences from the reference:
  * `_hash3`'s uint32 arithmetic, which wraps, runs in int64 masked to 32
    bits after every step; the multiply by a constant above 2^31 is split so
    no product leaves the int64 range. The hash is exact on every device and
    needs no uint32 op.
  * `render_sequence` is a loop over frames (the reference's `lax.map`),
    so peak memory is one frame's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.geom.lie import rotate_dirs
from vobench.reference.sensor.model import annulus_mask, lift, viewpoint
from vobench.reference.sensor.rig import OmnistereoRig

_MASK32 = 0xFFFFFFFF


class RoomScene(NamedTuple):
    """Analytic room: vertical cylinder wall + two horizontal planes."""

    radius: float = 6.0
    floor_z: float = -1.8
    ceiling_z: float = 2.2
    texture_scale: float = 1.2
    seed: int = 1234


def _mul32(n: torch.Tensor, c: int) -> torch.Tensor:
    """(n * c) mod 2^32 for int64 n in [0, 2^32) and a constant c < 2^32,
    with every intermediate below 2^63: where c >= 2^31 the product is split
    at n's 16th bit, and its high half only matters to 16 bits."""
    if c < 2**31:
        return (n * c) & _MASK32
    hi = ((n >> 16) * c) & 0xFFFF
    return ((hi << 16) + (n & 0xFFFF) * c) & _MASK32


def _hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, seed: int) -> torch.Tensor:
    """Deterministic lattice hash -> [0, 1) floats (integer mix, no tables);
    the reference's uint32 arithmetic on int64 values masked to 32 bits."""
    def u32(x):
        return x.to(torch.int64) & _MASK32

    n = _mul32(u32(ix), 73856093) ^ _mul32(u32(iy), 19349663) ^ _mul32(u32(iz), 83492791) \
        ^ (seed & _MASK32)
    n = _mul32(n, 2654435761)
    n = n ^ (n >> 13)
    n = _mul32(n, 1274126177)
    n = n ^ (n >> 16)
    return (n & 0x00FFFFFF).to(torch.float32) / float(0x01000000)


def value_noise(p: torch.Tensor, seed: int) -> torch.Tensor:
    """Trilinear value noise at (..., 3) points."""
    p0 = torch.floor(p)
    f = p - p0
    f = f * f * (3.0 - 2.0 * f)  # smoothstep
    i = p0.to(torch.int32)

    def corner(dx, dy, dz):
        return _hash3(i[..., 0] + dx, i[..., 1] + dy, i[..., 2] + dz, seed)

    c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
    c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
    c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
    c011, c111 = corner(0, 1, 1), corner(1, 1, 1)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    x00 = c000 + (c100 - c000) * fx
    x10 = c010 + (c110 - c010) * fx
    x01 = c001 + (c101 - c001) * fx
    x11 = c011 + (c111 - c011) * fx
    y0 = x00 + (x10 - x00) * fy
    y1 = x01 + (x11 - x01) * fy
    return y0 + (y1 - y0) * fz


def texture(p: torch.Tensor, scene: RoomScene) -> torch.Tensor:
    """Multi-octave value-noise texture in [0, 1]; corner-rich for Harris."""
    s = scene.texture_scale
    t = (0.55 * value_noise(p * s, scene.seed)
         + 0.3 * value_noise(p * (s * 3.1), scene.seed + 1)
         + 0.15 * value_noise(p * (s * 9.7), scene.seed + 2))
    # A faint checker guarantees strong corners everywhere.
    checker = torch.remainder(torch.floor(p[..., 0] * s * 2) + torch.floor(p[..., 1] * s * 2)
                              + torch.floor(p[..., 2] * s * 2), 2.0)
    return torch.clamp(0.75 * t + 0.25 * checker, 0.0, 1.0)


def _ray_room(origin: torch.Tensor, d: torch.Tensor, scene: RoomScene) -> torch.Tensor:
    """Nearest positive intersection parameter t of a ray with the room (inside)."""
    big = 1e9
    # Cylinder x^2 + y^2 = R^2 (infinite; capped by the planes below).
    a = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    b = 2.0 * (origin[..., 0] * d[..., 0] + origin[..., 1] * d[..., 1])
    c = origin[..., 0] * origin[..., 0] + origin[..., 1] * origin[..., 1] - scene.radius ** 2
    disc = b * b - 4.0 * a * c
    a_safe = torch.where(a > 1e-9, a, 1.0)
    t_cyl = (-b + torch.sqrt(torch.clamp_min(disc, 0.0))) / (2.0 * a_safe)  # outgoing root
    z_cyl = origin[..., 2] + t_cyl * d[..., 2]
    cyl_ok = ((a > 1e-9) & (disc > 0.0) & (t_cyl > 1e-4) & (z_cyl >= scene.floor_z)
              & (z_cyl <= scene.ceiling_z))
    t_cyl = torch.where(cyl_ok, t_cyl, big)
    # Planes.
    dz_ok = torch.abs(d[..., 2]) > 1e-9
    dz_safe = torch.where(dz_ok, d[..., 2], 1.0)
    t_fl = (scene.floor_z - origin[..., 2]) / dz_safe
    t_ce = (scene.ceiling_z - origin[..., 2]) / dz_safe
    t_fl = torch.where(dz_ok & (t_fl > 1e-4), t_fl, big)
    t_ce = torch.where(dz_ok & (t_ce > 1e-4), t_ce, big)
    return torch.minimum(t_cyl, torch.minimum(t_fl, t_ce))


def hit_points(rig: OmnistereoRig, T_world_rig: torch.Tensor, view, scene: RoomScene):
    """One view's world hit points (H, W, 3), ray parameters (H, W) and
    annulus mask (H, W) over the raw image at a rig pose."""
    h, w = rig.image_height, rig.image_width
    device = T_world_rig.device
    vv = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    uu = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    ray_v, ok = lift(view, torch.stack([uu, vv], dim=-1))       # rig-frame dirs
    mask = annulus_mask(view, h, w) & ok
    R = T_world_rig[:3, :3]
    origin = T_world_rig[:3, 3] + R @ viewpoint(view)            # world viewpoint
    d = rotate_dirs(R, ray_v.reshape(-1, 3)).reshape(h, w, 3)
    tt = _ray_room(origin.expand(d.shape), d, scene)
    return origin + tt[..., None] * d, tt, mask


def render_frame(rig: OmnistereoRig, T_world_rig: torch.Tensor,
                 scene: RoomScene = RoomScene()) -> torch.Tensor:
    """The raw omni image (H, W) f32 in [0, 1] at a rig pose, on the pose's
    device. Inner annulus = bottom mirror, outer annulus = top mirror (the
    top view wins where both annuli hold a pixel). The texture is
    elementwise, so it is evaluated once, on each pixel's own view's hit."""
    p_top, t_top, m_top = hit_points(rig, T_world_rig, rig.top, scene)
    p_bot, t_bot, m_bot = hit_points(rig, T_world_rig, rig.bottom, scene)
    hit = torch.where(m_top, t_top < 1e8, m_bot & (t_bot < 1e8))
    val = texture(torch.where(m_top[..., None], p_top, p_bot), scene)
    return torch.where(hit, val, 0.0)


def render_sequence(rig: OmnistereoRig, poses: torch.Tensor,
                    scene: RoomScene = RoomScene()) -> torch.Tensor:
    """(F, H, W) rendered sequence, one frame at a time."""
    return torch.stack([render_frame(rig, T, scene) for T in poses])
