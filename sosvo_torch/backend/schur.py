"""Closed-form small solvers (counterpart of the first part of
`sosvo/backend/schur.py`).

Only `inv3x3`, `solve6x6_spd` and `inv6x6_spd` are ported: the bearing
refine needs them. The Schur reduction of bundle adjustment
(`reduce_camera_system`, `back_substitute`) comes with the BA slice.
"""

from __future__ import annotations

import torch


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


def inv6x6_spd(H: torch.Tensor) -> torch.Tensor:
    """Closed-form (..., 6, 6) SPD inverse (block Schur over `inv3x3`)."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    Bt = B.transpose(-1, -2)
    Dinv = inv3x3(D)
    BDinv = B @ Dinv
    Sinv = inv3x3(A - BDinv @ Bt)
    TR = -Sinv @ BDinv
    BL = TR.transpose(-1, -2)
    BR = Dinv - BDinv.transpose(-1, -2) @ TR
    return torch.cat([torch.cat([Sinv, TR], dim=-1), torch.cat([BL, BR], dim=-1)], dim=-2)
