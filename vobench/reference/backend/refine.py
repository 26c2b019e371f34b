"""Nonlinear pose refinement on SE(3): fixed-iteration Huber-IRLS Gauss-Newton
on bearing residuals (counterpart of `sosvo/backend/refine.py:
refine_pose_bearings`).
"""

from __future__ import annotations

import torch

from vobench.reference.backend.schur import solve6x6_spd
from vobench.reference.geom.lie import norm, se3_exp, transform_points


def refine_pose_bearings(T_init: torch.Tensor, pts_prev: torch.Tensor, rays_curr: torch.Tensor,
                         weights: torch.Tensor, iters: int = 6, damping: float = 1e-4,
                         huber_delta: float = 0.01) -> torch.Tensor:
    """Refine T (curr-from-prev) so that T X_prev aligns with observed rays.

    Closed-form normal equations (see the reference for the derivation):
    with q = T p, d = q/|q|, r = d - ray and u = w/|q|, every needed moment
    is a block of C^T C for C = [u q | u d | q x r | r - d(d.r) | u | u w],
    so an iteration is one (14, N) x (N, 14) product, a 6x6 solve and a
    left retraction.
    """
    eye3 = torch.eye(3, dtype=T_init.dtype, device=T_init.device)
    eye6 = torch.eye(6, dtype=T_init.dtype, device=T_init.device)
    T = T_init
    for _ in range(iters):
        q = transform_points(T, pts_prev)                        # (N, 3)
        nq = torch.clamp_min(norm(q, keepdim=True), 1e-9)
        d = q / nq
        r = d - rays_curr
        nrm = norm(r)
        huber_w = torch.sqrt(torch.where(nrm <= huber_delta, 1.0,
                                         huber_delta / torch.clamp_min(nrm, 1e-12)))
        w = weights * huber_w
        u = w / nq[:, 0]
        uw = u * w
        Y = r - d * torch.sum(d * r, dim=-1, keepdim=True)
        C = torch.cat([u[:, None] * q, u[:, None] * d, torch.linalg.cross(q, r, dim=-1), Y,
                       u[:, None], uw[:, None]], dim=1)          # (N, 14)
        M = C.T @ C
        S_qq = M[0:3, 0:3]
        S_dd = M[3:6, 3:6]
        s1 = S_qq[0, 0] + S_qq[1, 1] + S_qq[2, 2]
        s0 = M[12, 12]
        m = M[0:3, 12]
        g_w = M[6:9, 13]
        g_v = M[9:12, 13]
        zero = torch.zeros_like(m[0])
        m_hat = torch.stack([
            torch.stack([zero, -m[2], m[1]], dim=-1),
            torch.stack([m[2], zero, -m[0]], dim=-1),
            torch.stack([-m[1], m[0], zero], dim=-1),
        ], dim=-2)
        H = torch.cat([torch.cat([s1 * eye3 - S_qq, m_hat], dim=1),
                       torch.cat([-m_hat, s0 * eye3 - S_dd], dim=1)], dim=0) + damping * eye6
        g = torch.cat([g_w, g_v])
        delta = -solve6x6_spd(H, g)
        T = se3_exp(delta) @ T
    return T
