"""Chessboard rig calibration: both views' intrinsics, the baseline and the
board poses in one damped Gauss-Newton problem (counterpart of
`sosvo/calib/boards.py`).

  parameters  p = [intrinsics_top (11) | intrinsics_bottom (11) | z_bottom (1)
                   | board poses (M, 6) as SE(3) tangents]
  residuals   r = every weighted reprojection error of the known board grid
                  through both views

Board poses start from a closed form that needs no PnP: each corner seen in
both views is stereo-triangulated (midpoint of the common perpendicular) and
the known grid is Umeyama-aligned to the triangulated cloud. The Jacobian is
`torch.func.jacfwd` of the residuals; each step's accept/reject is decided
on the device (`calib/fit.py:damped_step`), so a fit never reads a value
back until its caller does. `fit_rig_full_gum` runs two staged multi-starts
and keeps the one of lower rms, also on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from sosvo_torch.calib.fit import damped_step
from sosvo_torch.geom.lie import norm, se3_exp, se3_log
from sosvo_torch.geometry.align import umeyama
from sosvo_torch.geometry.triangulate import midpoint_triangulate
from sosvo_torch.sensor.model import ViewParams, lift, project, viewpoint
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.utils.device import resolve

# Per-view intrinsic block layout:
# [xi, fx, fy, cx, cy, k1, k2, p1, p2, mis_rx, mis_ry]  (full GUM)
N_INTR = 11
_MIS_IDX = (9, 10, N_INTR + 9, N_INTR + 10)


class BoardObservations(NamedTuple):
    """M boards x G grid corners observed through the omnistereo rig; a
    weight is 0 where a corner was not detected in that view."""

    pts_board: torch.Tensor   # (G, 3) known board-frame corner coordinates (z = 0)
    uv_top: torch.Tensor      # (M, G, 2) observed pixels in the top view
    w_top: torch.Tensor       # (M, G) detection weights
    uv_bottom: torch.Tensor   # (M, G, 2)
    w_bottom: torch.Tensor    # (M, G)


class RigCalibResult(NamedTuple):
    rig: OmnistereoRig        # calibrated rig (elevation bands kept from the init)
    poses: torch.Tensor       # (M, 4, 4) rig-from-board transforms
    rms_px: torch.Tensor      # () final reprojection RMS (pixels)
    rms0_px: torch.Tensor     # () RMS at the initialization
    accepted: torch.Tensor    # (iters,) LM step acceptance trace


def make_board_grid(nx: int = 8, ny: int = 6, square: float = 0.04,
                    device: torch.device | str | None = None) -> torch.Tensor:
    """(nx * ny, 3) planar chessboard corner grid, centred, z = 0, x-major."""
    device = resolve(device)
    xs = (torch.arange(nx, dtype=torch.float32, device=device) - (nx - 1) / 2.0) * square
    ys = (torch.arange(ny, dtype=torch.float32, device=device) - (ny - 1) / 2.0) * square
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), torch.zeros_like(gx).reshape(-1)],
                       dim=-1)


def init_board_poses(rig: OmnistereoRig, obs: BoardObservations) -> torch.Tensor:
    """(M, 4, 4) closed-form rig-from-board inits: triangulate + Umeyama."""
    ray_t, ok_t = lift(rig.top, obs.uv_top)
    ray_b, ok_b = lift(rig.bottom, obs.uv_bottom)
    c_t = viewpoint(rig.top).expand(ray_t.shape)
    c_b = viewpoint(rig.bottom).expand(ray_b.shape)
    tri = midpoint_triangulate(ray_t, ray_b, c_t, c_b)
    w = obs.w_top * obs.w_bottom * ok_t.float() * ok_b.float() * tri.valid.float()
    src = obs.pts_board.expand(tri.points.shape)
    T, _ = umeyama(src, tri.points, weights=w)
    return T


def _view(v0: ViewParams, q: torch.Tensor, **extra) -> ViewParams:
    return v0._replace(xi=q[0], fx=q[1], fy=q[2], cx=q[3], cy=q[4], k1=q[5], k2=q[6],
                       p1=q[7], p2=q[8], mis_rx=q[9], mis_ry=q[10], **extra)


def _unpack(p: torch.Tensor, rig0: OmnistereoRig, n_boards: int, unit: bool = False):
    """Parameter vector -> (top view, bottom view, (M, 4, 4) poses). With
    `unit` the views' fitted fields are (1,) tensors, not 0-d: under
    `torch.func.jacfwd` a 0-d tensor combined with a Python float takes a
    float64 tangent, and a unit batch dimension keeps every tangent f32."""
    q = p[:, None] if unit else p
    top = _view(rig0.top, q[:N_INTR])
    bottom = _view(rig0.bottom, q[N_INTR:2 * N_INTR], z_offset=q[2 * N_INTR])
    poses = se3_exp(p[2 * N_INTR + 1:].reshape(n_boards, 6))
    return top, bottom, poses


def _pack(rig: OmnistereoRig, pose_tangents: torch.Tensor) -> torch.Tensor:
    def intr(v: ViewParams):
        return torch.stack([v.xi, v.fx, v.fy, v.cx, v.cy, v.k1, v.k2, v.p1, v.p2,
                            v.mis_rx, v.mis_ry])
    return torch.cat([intr(rig.top), intr(rig.bottom), rig.bottom.z_offset[None],
                      pose_tangents.reshape(-1)])


def _residuals(p: torch.Tensor, rig0: OmnistereoRig, obs: BoardObservations) -> torch.Tensor:
    """Every weighted reprojection residual, flattened (4 M G,): top, then bottom."""
    top, bottom, poses = _unpack(p, rig0, obs.uv_top.shape[0], unit=True)
    pts_rig = torch.einsum("mij,gj->mgi", poses[:, :3, :3], obs.pts_board) + poses[:, None, :3, 3]

    def view_res(view: ViewParams, uv_obs, w):
        uv, _ = project(view, pts_rig - viewpoint(view))
        return ((uv - uv_obs) * w[..., None]).reshape(-1)

    return torch.cat([view_res(top, obs.uv_top, obs.w_top),
                      view_res(bottom, obs.uv_bottom, obs.w_bottom)])


def fit_rig_from_boards(
    rig0: OmnistereoRig,
    obs: BoardObservations,
    poses0: torch.Tensor | None = None,
    iters: int = 30,
    lam0: float = 1e-2,
    fit_baseline: bool = True,
    fit_distortion: bool = False,
    fit_misalignment: bool = False,
    fit_xi: bool = True,
    huber_delta_px: float | None = None,
    mis_prior_px_per_rad: float | torch.Tensor | None = None,
    mis_anchor: torch.Tensor | None = None,
) -> RigCalibResult:
    """Joint LM over both views' intrinsics, the baseline and the board poses.

    The options are the reference's (see `sosvo.calib.boards` for the
    measurements behind them): `fit_distortion` / `fit_misalignment` free
    the full-GUM terms of both views; `fit_xi=False` freezes the mirror
    parameter (xi and radial distortion share a near-gauge over a finite
    elevation band); `huber_delta_px` is a per-corner Huber IRLS scale whose
    weights are frozen per iteration, candidate and current cost compared
    under the same weights; `mis_prior_px_per_rad` is a quadratic prior
    pulling (mis_rx, mis_ry) of both views toward `mis_anchor` (default:
    this call's initialization), which resolves the common-mode
    misalignment gauge the free board poses would absorb.
    """
    m = obs.uv_top.shape[0]
    device = obs.uv_top.device
    if poses0 is None:
        poses0 = init_board_poses(rig0, obs)
    p = _pack(rig0, se3_log(poses0))
    n_params = p.shape[0]

    move = torch.ones((n_params,), dtype=torch.float32, device=device)
    move[2 * N_INTR] = 1.0 if fit_baseline else 0.0
    for base in (0, N_INTR):                       # top block, bottom block
        move[base + 5:base + 9] = 1.0 if fit_distortion else 0.0
        move[base + 9:base + 11] = 1.0 if fit_misalignment else 0.0
        if not fit_xi:
            move[base] = 0.0

    n_obs = torch.clamp_min(torch.sum(obs.w_top > 0) + torch.sum(obs.w_bottom > 0), 1)
    mis_idx = torch.tensor(_MIS_IDX, device=device)
    mis0 = p[mis_idx] if mis_anchor is None else torch.as_tensor(mis_anchor, device=device)

    def res(q):
        return _residuals(q, rig0, obs)

    def corner_sw(q):
        """(2 M G,) sqrt-Huber IRLS multiplier per corner observation."""
        r = res(q).reshape(-1, 2)
        if huber_delta_px is None:
            return torch.ones((r.shape[0],), dtype=r.dtype, device=device)
        return torch.sqrt(torch.clamp_max(huber_delta_px / torch.clamp_min(norm(r), 1e-9), 1.0))

    def wres(q, sw):
        r = (res(q).reshape(-1, 2) * sw[:, None]).reshape(-1)
        if mis_prior_px_per_rad is not None:
            r = torch.cat([r, (q[mis_idx] - mis0) * mis_prior_px_per_rad])
        return r

    def rms(q, sw):
        r = wres(q, sw)
        return torch.sqrt(torch.sum(r * r) / n_obs)

    cost0 = rms(p, corner_sw(p))
    lam = torch.tensor(lam0, dtype=torch.float32, device=device)
    accepted = []
    for _ in range(iters):
        sw = corner_sw(p)  # frozen for this iteration (IRLS)
        cost = rms(p, sw)
        J = jacfwd(lambda q: wres(q, sw))(p) * move[None, :]
        p, lam, _, acc = damped_step(p, lam, cost, wres(p, sw), J, move,
                                     lambda q: rms(q, sw), marquardt=True)
        accepted.append(acc)
    cost_fin = rms(p, corner_sw(p))
    top, bottom, poses = _unpack(p, rig0, m)
    acc_trace = torch.stack(accepted) if accepted else torch.zeros((0,), dtype=torch.bool,
                                                                   device=device)
    return RigCalibResult(rig=rig0._replace(top=top, bottom=bottom), poses=poses,
                          rms_px=cost_fin, rms0_px=cost0, accepted=acc_trace)


def _pick(better_a: torch.Tensor, a, b):
    """`a` where `better_a`, else `b`, leaf by leaf (ints are the same in both)."""
    if isinstance(a, torch.Tensor):
        return torch.where(better_a, a, b)
    if isinstance(a, tuple):
        return type(a)(*(_pick(better_a, x, y) for x, y in zip(a, b)))
    return a


def fit_rig_full_gum(rig0: OmnistereoRig, obs: BoardObservations, iters: int = 30,
                     huber_delta_px: float | None = 2.0) -> RigCalibResult:
    """Staged full-GUM calibration, the reference's recipe: xi frozen at its
    prior throughout; stage 1 fits pinhole intrinsics with either
    distortion or misalignment, stages 2-3 free both, stage 4 polishes with
    a misalignment prior scaled to the data's noise (clip(12 rms, 1, 100)
    px/rad). Both stage-1 orderings run (each converges where the other
    stalls) and the lower final rms wins; `rms0_px` is stage 1's initial
    rms."""
    hd = huber_delta_px
    # The prior anchors at the design misalignment (rig0's), not at a
    # stage's possibly wrong estimate.
    anchor = torch.stack([rig0.top.mis_rx, rig0.top.mis_ry,
                          rig0.bottom.mis_rx, rig0.bottom.mis_ry])

    def staged(first_kw: dict) -> RigCalibResult:
        r1 = fit_rig_from_boards(rig0, obs, iters=iters, fit_xi=False,
                                 huber_delta_px=None if hd is None else 2 * hd,
                                 mis_prior_px_per_rad=30.0, mis_anchor=anchor, **first_kw)
        kw = dict(fit_distortion=True, fit_misalignment=True, fit_xi=False,
                  huber_delta_px=hd, mis_anchor=anchor)
        r2 = fit_rig_from_boards(r1.rig, obs, poses0=r1.poses, iters=iters,
                                 mis_prior_px_per_rad=30.0, **kw)
        r3 = fit_rig_from_boards(r2.rig, obs, poses0=r2.poses, iters=iters + 10,
                                 mis_prior_px_per_rad=30.0, **kw)
        w4 = torch.clamp(12.0 * r3.rms_px, 1.0, 100.0)
        r4 = fit_rig_from_boards(r3.rig, obs, poses0=r3.poses, iters=iters,
                                 mis_prior_px_per_rad=w4, **kw)
        return r4._replace(rms0_px=r1.rms0_px)

    ra = staged(dict(fit_distortion=True))
    rb = staged(dict(fit_misalignment=True))
    return _pick(ra.rms_px <= rb.rms_px, ra, rb)
