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
  * The Schur reduction is `reduce_camera_system_cuda`: the CUDA kernel on
    CUDA tensors, its plain version on CPU tensors. There is no switch.
  * `lax.scan` becomes a Python loop of fixed length; accept/reject stays a
    `torch.where` on the device, so `ba_solve` never reads back from it.

Landmark sharding (config c5): with `axis` (a `sosvo_torch.dist.mesh.Axis`,
the counterpart of `axis_name`) the window's landmark axis holds this
rank's shard. The landmark sums the JAX package psums are summed over the
axis: the costs, and per LM step H_cc, b_c, the gauge `coupling` and the
Schur reduction's S_off and b_sub, all five in one buffer. Damping and the
gauge prior are added after the sum, so once and alike on every rank; every
accept/reject keys on a summed cost, so all ranks take the same branch.

Spans (`utils/spans.py`): per LM iteration `ba.build` (the normal-equation
blocks), `ba.schur` (gauge and Schur reduction) and `ba.solve` (the reduced
solve, back-substitution and pose update), counted as `ba.lm_iters`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sosvo_torch.backend.schur import apply_pose_updates, assemble_camera_system, back_substitute
from sosvo_torch.geom.lie import norm
from sosvo_torch.kernels.schur_cuda import reduce_camera_system_cuda, schur_parts
from sosvo_torch.utils import spans

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


def build_blocks(win: BAWindow, axis=None):
    """All BA normal-equation blocks over the dense (W, L) grid:
    H_cc (W, 6, 6), H_cl (W, L, 6, 3), H_ll (L, 3, 3), b_c (W, 6),
    b_l (L, 3), cost (). With `axis` the landmark-indexed blocks are this
    shard's and H_cc, b_c and cost are summed over the axis."""
    r, J_pose, J_lm = _pair_jacobians(win)
    H_cc = torch.einsum("wlri,wlrj->wij", J_pose, J_pose)
    H_cl = torch.einsum("wlri,wlrj->wlij", J_pose, J_lm)
    H_ll = torch.einsum("wlri,wlrj->lij", J_lm, J_lm)
    b_c = torch.einsum("wlri,wlr->wi", J_pose, r)
    b_l = torch.einsum("wlri,wlr->li", J_lm, r)
    cost = 0.5 * torch.sum(r * r)
    if axis is not None:
        H_cc, b_c, cost = axis.psum(H_cc, b_c, cost)
    return H_cc, H_cl, H_ll, b_c, b_l, cost


def ba_cost(win: BAWindow, axis=None) -> torch.Tensor:
    """Weighted SSE of the window (no Jacobians; the accept/reject probe),
    summed over `axis`."""
    r = _residuals(win)
    cost = 0.5 * torch.sum(r * r)
    return cost if axis is None else axis.psum(cost)


def huber_weights(win: BAWindow, delta: float) -> torch.Tensor:
    """(W, L, 2) IRLS multipliers: sqrt-Huber on each observation's bearing
    residual norm."""
    _, n, _ = _normalize(_rig_points(win), win.viewpoints)
    nrm = norm(n - win.rays)
    one = torch.ones((), dtype=nrm.dtype, device=nrm.device)
    return torch.sqrt(torch.where(nrm <= delta, one, delta / torch.clamp_min(nrm, 1e-12)))


def lm_step(win: BAWindow, lam: torch.Tensor, anchor: torch.Tensor | int = 0,
            axis=None) -> BAWindow:
    """One damped LM step: build blocks, Schur-reduce, solve, back-substitute.

    Returns the CANDIDATE window (the caller decides accept/reject).
    `anchor` is the gauge keyframe slot (an int or a 0-dim device tensor).
    With `axis`, each rank reduces its landmark shard, the camera system is
    summed over the axis and solved alike on every rank, and each rank
    back-substitutes its own landmarks.
    """
    W = win.X.shape[0]
    dtype, device = win.X.dtype, win.X.device
    with spans.span("ba.build"):
        H_cc, H_cl, H_ll, b_c, b_l, _ = build_blocks(win)
    with spans.span("ba.schur"):
        # Gauge support must agree on every rank: H_cl holds this shard only.
        coupling = torch.sum(torch.abs(H_cl), dim=(1, 2, 3))
        if axis is not None:
            # This shard's Schur partials first (the kernel's S goes unused), then
            # every landmark sum in one all-reduce.
            parts = schur_parts(H_cc, H_cl, H_ll, b_c, b_l, lam, damp_H_cc=False)
            H_cc, b_c, coupling, S_off, b_sub = axis.psum(H_cc, b_c, coupling, parts.S_off,
                                                          parts.b_sub)

        eye6 = torch.eye(6, dtype=dtype, device=device)
        one_hot = (torch.arange(W, device=device) == anchor).to(dtype)
        # Damping and the gauge prior come after the sum: applied once.
        H_cc = H_cc + lam * eye6[None]
        # Gauge: clamp the anchor keyframe with a huge prior; unobserved pose
        # slots (all-zero rows) get it too, so the reduced system stays regular.
        row_support = torch.sum(torch.abs(b_c), dim=-1) + coupling
        unobserved = (row_support == 0.0).to(dtype)
        clamp = torch.maximum(one_hot, unobserved)
        H_cc = H_cc + (GAUGE_PRIOR * clamp)[:, None, None] * eye6[None]

        if axis is None:
            S, b_red, H_ll_inv = reduce_camera_system_cuda(H_cc, H_cl, H_ll, b_c, b_l, lam,
                                                           damp_H_cc=False)
        else:
            S, b_red = assemble_camera_system(H_cc, b_c, S_off, b_sub)
            H_ll_inv = parts.H_ll_inv

    with spans.span("ba.solve"):
        # Dense solve of the reduced (6W, 6W) camera system (cameras are few).
        # `solve_ex` leaves its status on the device: no read-back.
        S_flat = S.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
        sol = torch.linalg.solve_ex(S_flat, b_red.reshape(6 * W, 1))[0]
        delta_c = -sol.reshape(W, 6) * (1.0 - clamp)[:, None]   # exact gauge clamp

        delta_l = back_substitute(H_ll_inv, H_cl, b_l, delta_c)
        return win._replace(X=apply_pose_updates(win.X, delta_c),
                            landmarks=win.landmarks + delta_l)


def ba_solve(win: BAWindow, iters: int = 5, lam0: float = 1e-3,
             anchor: torch.Tensor | int = 0, huber_delta: float | None = None,
             axis=None) -> BAResult:
    """Levenberg-Marquardt with multiplicative damping adaptation: accept a
    step iff it lowers the cost (then lam /= 3), else keep the old state and
    raise lam x 9; a fixed number of iterations, all decisions on the device.
    With `axis` the window's landmarks are this rank's shard (the result's
    too) and every decision keys on costs summed over the axis.
    """
    cost0 = ba_cost(win, axis)
    lam = torch.full((), lam0, dtype=win.X.dtype, device=win.X.device)
    w, cost = win, cost0
    accepted = []
    for _ in range(iters):
        spans.count("ba.lm_iters")
        if huber_delta is not None:
            # IRLS: freeze the Huber multipliers at the current state; the
            # candidate and the current state are compared under them.
            w_eff = w._replace(weights=w.weights * huber_weights(w, huber_delta))
            cost = ba_cost(w_eff, axis)
        else:
            w_eff = w
        cand = lm_step(w_eff, lam, anchor, axis)
        cand_cost = ba_cost(cand._replace(weights=w_eff.weights), axis)
        accept = cand_cost < cost
        w = w._replace(X=torch.where(accept, cand.X, w.X),
                       landmarks=torch.where(accept, cand.landmarks, w.landmarks))
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 9.0), 1e-8, 1e4)
        cost = torch.where(accept, cand_cost, cost)
        accepted.append(accept)
    return BAResult(X=w.X, landmarks=w.landmarks, cost=cost, cost0=cost0,
                    accepted=torch.stack(accepted))
