"""Closed-form small solvers and the Schur-complement primitives of windowed
BA (counterpart of `sosvo/backend/schur.py`).

`inv3x3` followed by `schur_terms` and `assemble_camera_system` is the
plain version of the CUDA Schur-reduction kernel
(`sosvo_torch/kernels/schur_cuda.py`), as `reference/kernels.py` composes
them.
"""

from __future__ import annotations

import torch

from vobench.reference.geom.lie import se3_exp


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse via the adjugate ((..., 3, 3)).

    Assumes well-conditioned (damped) inputs; no pivoting.
    """
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    inv_det = 1.0 / (a * A + b * B + c * C)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def solve6x6_spd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Closed-form (..., 6, 6) SPD solve via one 2x2-block Schur step:
    S = A - B D^-1 B^T, x1 = S^-1 (g1 - B D^-1 g2), x2 = D^-1 (g2 - B^T x1).
    No pivoting: callers damp."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    g1 = g[..., :3, None]
    g2 = g[..., 3:, None]
    Bt = B.transpose(-1, -2)
    Dinv = inv3x3(D)
    BDinv = B @ Dinv
    S = A - BDinv @ Bt
    x1 = inv3x3(S) @ (g1 - BDinv @ g2)
    x2 = Dinv @ (g2 - Bt @ x1)
    return torch.cat([x1, x2], dim=-2)[..., 0]


def schur_terms(H_cl: torch.Tensor, H_ll_inv: torch.Tensor, b_l: torch.Tensor):
    """The landmark sums of the Schur complement: S_off (W, W, 6, 6) =
    sum_l A[:, l] H_cl[:, l]^T and b_sub (W, 6) = sum_l A[:, l] b_l[l], with
    A[w, l] = H_cl[w, l] H_ll_inv[l]."""
    A = torch.einsum("wlij,ljk->wlik", H_cl, H_ll_inv)      # (W, L, 6, 3)
    S_off = torch.einsum("wlik,vljk->wvij", A, H_cl)         # (W, W, 6, 6)
    b_sub = torch.einsum("wlik,lk->wi", A, b_l)
    return S_off, b_sub


def assemble_camera_system(H_cc: torch.Tensor, b_c: torch.Tensor, S_off: torch.Tensor,
                           b_sub: torch.Tensor):
    """S = blockdiag(H_cc) - S_off (W, W, 6, 6) and b_red = b_c - b_sub (W, 6)."""
    eye_w = torch.eye(H_cc.shape[0], dtype=H_cc.dtype, device=H_cc.device)
    return eye_w[:, :, None, None] * H_cc[:, None] - S_off, b_c - b_sub


def back_substitute(H_ll_inv: torch.Tensor, H_cl: torch.Tensor, b_l: torch.Tensor,
                    delta_c: torch.Tensor) -> torch.Tensor:
    """Per-landmark update given the pose solution (L, 3):

        delta_l[l] = -H_ll_inv[l] (b_l[l] + sum_w H_cl[w,l]^T delta_c[w])
    """
    rhs = b_l + torch.einsum("wlij,wi->lj", H_cl, delta_c)
    return -torch.einsum("lij,lj->li", H_ll_inv, rhs)


def apply_pose_updates(X: torch.Tensor, delta_c: torch.Tensor) -> torch.Tensor:
    """Left-retract each pose: X[w] <- exp(delta_c[w]) X[w]. (W, 4, 4)."""
    return se3_exp(delta_c) @ X
