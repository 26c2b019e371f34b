"""Calibration fitting: one view's unified-model parameters from control
points (counterpart of `sosvo/calib/fit.py`).

Damped Gauss-Newton on the reprojection residual, its Jacobian by forward
differentiation (`torch.func.jacfwd`) through the port's projection. The
parameter vector is tiny (12), so the normal equations are solved densely.
Each step's accept/reject and the damping update are `torch.where` selects
on the device: the loop never reads a value back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from sosvo_torch.sensor.model import ViewParams, project

# Parameter vector layout:
# [xi, fx, fy, cx, cy, z_offset, k1, k2, p1, p2, mis_rx, mis_ry]
N_PARAMS = 12


def params_to_vector(v: ViewParams) -> torch.Tensor:
    return torch.stack([v.xi, v.fx, v.fy, v.cx, v.cy, v.z_offset,
                        v.k1, v.k2, v.p1, v.p2, v.mis_rx, v.mis_ry])


def vector_to_params(p: torch.Tensor, template: ViewParams) -> ViewParams:
    return template._replace(xi=p[0], fx=p[1], fy=p[2], cx=p[3], cy=p[4], z_offset=p[5],
                             k1=p[6], k2=p[7], p1=p[8], p2=p[9], mis_rx=p[10], mis_ry=p[11])


class CalibResult(NamedTuple):
    view: ViewParams
    rms_px: torch.Tensor     # () residual RMS in pixels
    rms0_px: torch.Tensor    # () initial RMS
    accepted: torch.Tensor   # (iters,) LM acceptance trace


def _residuals(p: torch.Tensor, template: ViewParams, pts_view: torch.Tensor,
               uv_obs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted reprojection residuals (2N,); z_offset shifts the viewpoint
    along the axis."""
    q = p[:, None]  # (1,) fields: see calib/boards.py:_unpack on jacfwd's tangents
    view = vector_to_params(q, template)
    dz = q[5] - template.z_offset
    shift = torch.stack([torch.zeros_like(dz), torch.zeros_like(dz), dz], dim=-1)
    uv, _ = project(view, pts_view - shift)
    return ((uv - uv_obs) * w[:, None]).reshape(-1)


def damped_step(p, lam, cost, r, J, move, rms, marquardt: bool):
    """One damped Gauss-Newton step, decided on the device: solve
    (J^T J + lam D) d = J^T r (D = I, or diag(J^T J) for Marquardt scaling),
    accept p - d where it lowers `rms`, and divide lam by 3 on acceptance or
    multiply it by 9 on rejection. Returns (p, lam, cost, accepted)."""
    H = J.T @ J
    if marquardt:
        D = torch.diag(torch.clamp_min(torch.diagonal(H), 1e-8))
    else:
        D = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    # solve_ex leaves its status on the device: no read-back.
    delta = torch.linalg.solve_ex(H + lam * D, (J.T @ r)[:, None])[0][:, 0]
    cand = p - delta * move
    cand_cost = rms(cand)
    accept = cand_cost < cost
    lam_next = torch.clamp(torch.where(accept, lam / 3.0, lam * 9.0), 1e-10, 1e6)
    return (torch.where(accept, cand, p), lam_next, torch.where(accept, cand_cost, cost), accept)


def fit_view(init: ViewParams, pts_view: torch.Tensor, uv_obs: torch.Tensor,
             weights: torch.Tensor | None = None, iters: int = 20, lam0: float = 1e-2,
             fit_z_offset: bool = False, fit_distortion: bool = False,
             fit_misalignment: bool = False) -> CalibResult:
    """LM-fit one view's parameters to (N, 3) view-frame control points and
    their (N, 2) measured pixels. `fit_distortion` frees (k1, k2, p1, p2),
    `fit_misalignment` (mis_rx, mis_ry); held at their initial values
    otherwise."""
    device = pts_view.device
    n = pts_view.shape[0]
    w = torch.ones((n,), dtype=torch.float32, device=device) if weights is None else weights
    p = params_to_vector(init)
    wsum = torch.clamp_min(torch.sum(w > 0), 1)
    dist = 1.0 if fit_distortion else 0.0
    mis = 1.0 if fit_misalignment else 0.0
    move = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0, 1.0 if fit_z_offset else 0.0,
                         dist, dist, dist, dist, mis, mis], device=device)

    def res(q):
        return _residuals(q, init, pts_view, uv_obs, w)

    def rms(q):
        r = res(q)
        return torch.sqrt(torch.sum(r * r) / wsum)

    cost0 = rms(p)
    cost, lam = cost0, torch.tensor(lam0, dtype=torch.float32, device=device)
    accepted = []
    for _ in range(iters):
        J = jacfwd(res)(p) * move[None, :]
        p, lam, cost, acc = damped_step(p, lam, cost, res(p), J, move, rms, marquardt=False)
        accepted.append(acc)
    acc_trace = torch.stack(accepted) if accepted else torch.zeros((0,), dtype=torch.bool,
                                                                   device=device)
    return CalibResult(view=vector_to_params(p, init), rms_px=cost, rms0_px=cost0,
                       accepted=acc_trace)
