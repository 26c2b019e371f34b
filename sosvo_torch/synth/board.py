"""Synthetic chessboard captures through the omnistereo model (counterpart of
`sosvo/synth/board.py`).

Every raw-image pixel is lifted to its rig-frame ray (`sensor/model.py:lift`),
intersected with the board plane and shaded by the checker parity, 2x2
supersampled so the saddle detector sees anti-aliased corners. The image is
rendered on the device of the rig.
"""

from __future__ import annotations

import torch

from sosvo_torch.geom.lie import mat_inv
from sosvo_torch.sensor.model import ViewParams, annulus_mask, lift, viewpoint
from sosvo_torch.sensor.rig import OmnistereoRig

# The 2x2 supersampling offsets (u, v) in pixels, in the reference's order.
_OFFSETS = ((-0.25, -0.25), (0.25, -0.25), (-0.25, 0.25), (0.25, 0.25))


def _checker(x: torch.Tensor, y: torch.Tensor, nx: int, ny: int, square: float) -> torch.Tensor:
    """Checker shade at board-frame (x, y): (nx + 1) x (ny + 1) squares
    centred as `calib.boards.make_board_grid`'s (nx, ny) inner corners, a
    white border half a square wide around them, background 0.5 beyond."""
    ix = torch.floor(x / square + (nx + 1) / 2.0)
    iy = torch.floor(y / square + (ny + 1) / 2.0)
    inside = (ix >= 0) & (ix <= nx) & (iy >= 0) & (iy <= ny)
    parity = torch.remainder(ix + iy, 2.0)
    border = ((torch.abs(x) <= (nx + 1) / 2.0 * square + 0.5 * square)
              & (torch.abs(y) <= (ny + 1) / 2.0 * square + 0.5 * square))
    return torch.where(inside, parity, torch.where(border, 1.0, 0.5))


def _shade_view(view: ViewParams, X: torch.Tensor, h: int, w: int, nx: int, ny: int,
                square: float, background: float) -> torch.Tensor:
    """(H, W) supersampled board shade seen through one view (board-from-rig X)."""
    device = X.device
    o_b = X[:3, :3] @ viewpoint(view) + X[:3, 3]       # viewpoint in the board frame
    acc = torch.zeros((h, w), dtype=torch.float32, device=device)
    for du, dv in _OFFSETS:
        vv = torch.arange(h, dtype=torch.float32, device=device)[:, None] + dv
        uu = torch.arange(w, dtype=torch.float32, device=device)[None, :] + du
        uv = torch.stack([uu.expand(h, w), vv.expand(h, w)], dim=-1)
        ray, ok = lift(view, uv)                        # rig-frame directions
        d_b = ray @ X[:3, :3].T
        dz = d_b[..., 2]
        t = -o_b[2] / torch.where(torch.abs(dz) < 1e-6, 1e-6, dz)
        hit = ok & (t > 0.05) & (torch.abs(dz) >= 1e-6)
        px = o_b[0] + t * d_b[..., 0]
        py = o_b[1] + t * d_b[..., 1]
        acc = acc + torch.where(hit, _checker(px, py, nx, ny, square), background)
    return acc / float(len(_OFFSETS))


def render_board_frame(rig: OmnistereoRig, T_rig_board: torch.Tensor, nx: int = 7, ny: int = 5,
                       square: float = 0.06, background: float = 0.5) -> torch.Tensor:
    """Raw omni image (H, W) of one chessboard at `T_rig_board`: the outer
    annulus through the top view, the inner through the bottom, 0 elsewhere."""
    h, w = rig.image_height, rig.image_width
    X = mat_inv(T_rig_board.to(device=rig.top.fx.device, dtype=torch.float32))
    img_top = _shade_view(rig.top, X, h, w, nx, ny, square, background)
    img_bot = _shade_view(rig.bottom, X, h, w, nx, ny, square, background)
    m_top = annulus_mask(rig.top, h, w)
    m_bot = annulus_mask(rig.bottom, h, w)
    return torch.where(m_top, img_top, torch.where(m_bot, img_bot, 0.0))
