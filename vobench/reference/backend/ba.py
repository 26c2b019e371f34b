"""Windowed bundle adjustment: Levenberg-Marquardt with a Schur complement
(counterpart of `sosvo/backend/ba.py`).

The window is a dense fixed-size problem: W keyframe poses x L landmark
slots x 2 views, with a (W, L, 2) weight mask selecting real observations.
Residuals are the two views' bearing errors; the camera system is reduced
by the Schur complement and the landmarks are back-substituted.

Differences from the reference:
  * The block Jacobians are in closed form instead of `jax.jacfwd`: for the
    left perturbation X <- exp(delta) X the rig-frame point q moves by
    [-[q]x | I] delta, the world point by R dp, and the normalization
    n = d * rsqrt(|d|^2 + eps) has the Jacobian rsqrt(s) (I - d d^T / s),
    s = |d|^2 + eps. Weight-0 slots get exactly zero blocks, as the
    reference's smooth rsqrt form gives them (see `_pair_residual`).
  * The Schur reduction is `reference/kernels.py:reduce_camera_system`, the
    plain definition of the program's CUDA kernel.
  * `lax.scan` becomes a Python loop of fixed length; accept/reject stays a
    `torch.where` on the device, so `ba_solve` never reads back from it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.backend.schur import apply_pose_updates, back_substitute
from vobench.reference.geom.lie import norm
from vobench.reference.kernels import reduce_camera_system

GAUGE_PRIOR = 1e8


class BAWindow(NamedTuple):
    """Fixed-size windowed BA problem. Field meanings as in
    `sosvo.backend.ba.BAWindow`."""

    X: torch.Tensor           # (W, 4, 4) rig-from-world pose per keyframe
    landmarks: torch.Tensor   # (L, 3) world-frame landmark positions
    rays: torch.Tensor        # (W, L, 2, 3) observed unit bearings (top, bottom)
    weights: torch.Tensor     # (W, L, 2) observation weights; 0 = no observation
    viewpoints: torch.Tensor  # (2, 3) per-view viewpoint offsets in the rig frame


class BAResult(NamedTuple):
    X: torch.Tensor           # (W, 4, 4) refined rig-from-world poses
    landmarks: torch.Tensor   # (L, 3) refined landmarks
    cost: torch.Tensor        # () final weighted SSE
    cost0: torch.Tensor       # () initial weighted SSE
    accepted: torch.Tensor    # (iters,) bool per-iteration step acceptance


def _rig_points(win: BAWindow) -> torch.Tensor:
    """(W, L, 3) every landmark in every keyframe's rig frame."""
    R = win.X[:, :3, :3]
    t = win.X[:, :3, 3]
    return win.landmarks[None] @ R.transpose(-1, -2) + t[:, None, :]


def _normalize(p_rig: torch.Tensor, viewpoints: torch.Tensor):
    """(d, n, rs): offsets from each viewpoint (W, L, 2, 3), their smooth
    normalization d * rsqrt(|d|^2 + 1e-18), and that rsqrt (W, L, 2, 1).

    The smooth form (not d / max(|d|, eps)) keeps the Jacobian of an empty
    slot seen from a keyframe at a viewpoint finite: see the reference's
    `_pair_residual` docstring."""
    d = p_rig[:, :, None, :] - viewpoints
    rs = torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-18)
    return d, d * rs, rs


def _residuals(win: BAWindow) -> torch.Tensor:
    """(W, L, 6) weighted bearing residuals (2 views x 3)."""
    _, n, _ = _normalize(_rig_points(win), win.viewpoints)
    r = (n - win.rays) * win.weights[..., None]
    return r.reshape(r.shape[0], r.shape[1], 6)


def _pair_jacobians(win: BAWindow):
    """Residuals (W, L, 6) and their Jacobians wrt each pose's tangent
    (W, L, 6, 6) and each landmark (W, L, 6, 3)."""
    W, L = win.rays.shape[:2]
    q = _rig_points(win)                                   # (W, L, 3)
    d, n, rs = _normalize(q, win.viewpoints)               # (W, L, 2, 3)
    wv = win.weights[..., None]                            # (W, L, 2, 1)
    r = ((n - win.rays) * wv).reshape(W, L, 6)
    # dn/dd = rs (I - d d^T rs^2), weighted.
    eye3 = torch.eye(3, dtype=q.dtype, device=q.device)
    dn = (eye3 - d[..., :, None] * d[..., None, :] * (rs * rs)[..., None]) * (rs * wv)[..., None]
    # dq/d(delta) = [-[q]x | I]; dq/dp = R.
    qx, qy, qz = q[..., 0], q[..., 1], q[..., 2]
    z = torch.zeros_like(qx)
    neg_hat_q = torch.stack([torch.stack([z, qz, -qy], dim=-1),
                             torch.stack([-qz, z, qx], dim=-1),
                             torch.stack([qy, -qx, z], dim=-1)], dim=-2)   # (W, L, 3, 3)
    dq = torch.cat([neg_hat_q, eye3.expand(W, L, 3, 3)], dim=-1)          # (W, L, 3, 6)
    J_pose = (dn @ dq[:, :, None]).reshape(W, L, 6, 6)
    R = win.X[:, :3, :3]
    J_lm = (dn @ R[:, None, None]).reshape(W, L, 6, 3)
    return r, J_pose, J_lm


def build_blocks(win: BAWindow):
    """All BA normal-equation blocks over the dense (W, L) grid:
    H_cc (W, 6, 6), H_cl (W, L, 6, 3), H_ll (L, 3, 3), b_c (W, 6),
    b_l (L, 3), cost ()."""
    r, J_pose, J_lm = _pair_jacobians(win)
    H_cc = torch.einsum("wlri,wlrj->wij", J_pose, J_pose)
    H_cl = torch.einsum("wlri,wlrj->wlij", J_pose, J_lm)
    H_ll = torch.einsum("wlri,wlrj->lij", J_lm, J_lm)
    b_c = torch.einsum("wlri,wlr->wi", J_pose, r)
    b_l = torch.einsum("wlri,wlr->li", J_lm, r)
    cost = 0.5 * torch.sum(r * r)
    return H_cc, H_cl, H_ll, b_c, b_l, cost


def ba_cost(win: BAWindow) -> torch.Tensor:
    """Weighted SSE of the window (no Jacobians; the accept/reject probe)."""
    r = _residuals(win)
    return 0.5 * torch.sum(r * r)


def huber_weights(win: BAWindow, delta: float) -> torch.Tensor:
    """(W, L, 2) IRLS multipliers: sqrt-Huber on each observation's bearing
    residual norm."""
    _, n, _ = _normalize(_rig_points(win), win.viewpoints)
    nrm = norm(n - win.rays)
    one = torch.ones((), dtype=nrm.dtype, device=nrm.device)
    return torch.sqrt(torch.where(nrm <= delta, one, delta / torch.clamp_min(nrm, 1e-12)))


def lm_step(win: BAWindow, lam: torch.Tensor, anchor: torch.Tensor | int = 0) -> BAWindow:
    """One damped LM step: build blocks, Schur-reduce, solve, back-substitute.

    Returns the CANDIDATE window (the caller decides accept/reject).
    `anchor` is the gauge keyframe slot (an int or a 0-dim device tensor).
    """
    W = win.X.shape[0]
    dtype, device = win.X.dtype, win.X.device
    H_cc, H_cl, H_ll, b_c, b_l, _ = build_blocks(win)
    coupling = torch.sum(torch.abs(H_cl), dim=(1, 2, 3))

    eye6 = torch.eye(6, dtype=dtype, device=device)
    one_hot = (torch.arange(W, device=device) == anchor).to(dtype)
    H_cc = H_cc + lam * eye6[None]
    # Gauge: clamp the anchor keyframe with a huge prior; unobserved pose
    # slots (all-zero rows) get it too, so the reduced system stays regular.
    row_support = torch.sum(torch.abs(b_c), dim=-1) + coupling
    unobserved = (row_support == 0.0).to(dtype)
    clamp = torch.maximum(one_hot, unobserved)
    H_cc = H_cc + (GAUGE_PRIOR * clamp)[:, None, None] * eye6[None]

    S, b_red, H_ll_inv = reduce_camera_system(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc=False)

    # Dense solve of the reduced (6W, 6W) camera system (cameras are few).
    # `solve_ex` leaves its status on the device: no read-back.
    S_flat = S.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
    sol = torch.linalg.solve_ex(S_flat, b_red.reshape(6 * W, 1))[0]
    delta_c = -sol.reshape(W, 6) * (1.0 - clamp)[:, None]   # exact gauge clamp

    delta_l = back_substitute(H_ll_inv, H_cl, b_l, delta_c)
    return win._replace(X=apply_pose_updates(win.X, delta_c),
                        landmarks=win.landmarks + delta_l)


def ba_solve(win: BAWindow, iters: int = 5, lam0: float = 1e-3,
             anchor: torch.Tensor | int = 0, huber_delta: float | None = None) -> BAResult:
    """Levenberg-Marquardt with multiplicative damping adaptation: accept a
    step iff it lowers the cost (then lam /= 3), else keep the old state and
    raise lam x 9; a fixed number of iterations, all decisions on the device.
    """
    cost0 = ba_cost(win)
    lam = torch.full((), lam0, dtype=win.X.dtype, device=win.X.device)
    w, cost = win, cost0
    accepted = []
    for _ in range(iters):
        if huber_delta is not None:
            # IRLS: freeze the Huber multipliers at the current state; the
            # candidate and the current state are compared under them.
            w_eff = w._replace(weights=w.weights * huber_weights(w, huber_delta))
            cost = ba_cost(w_eff)
        else:
            w_eff = w
        cand = lm_step(w_eff, lam, anchor)
        cand_cost = ba_cost(cand._replace(weights=w_eff.weights))
        accept = cand_cost < cost
        w = w._replace(X=torch.where(accept, cand.X, w.X),
                       landmarks=torch.where(accept, cand.landmarks, w.landmarks))
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 9.0), 1e-8, 1e4)
        cost = torch.where(accept, cand_cost, cost)
        accepted.append(accept)
    return BAResult(X=w.X, landmarks=w.landmarks, cost=cost, cost0=cost0,
                    accepted=torch.stack(accepted))
