"""3D-3D rigid alignment (Kabsch-Umeyama), batched (counterpart of
`sosvo/geometry/align.py`).

Weighted, so fixed-size masked point sets work (zero-weight rows are
ignored exactly). The rotation comes from Horn's quaternion method with the
largest eigenpair found QCP-style (Newton on the quartic characteristic
polynomial + adjugate kernel extraction): a fixed sequence of elementwise
ops, always a proper rotation. See the reference module for the derivation
and for why the adjugate form replaced a shifted Cholesky.
"""

from __future__ import annotations

import torch

from vobench.reference.geom.lie import norm, rt_to_mat


def umeyama(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor | None = None,
            with_scale: bool = False):
    """Weighted Kabsch-Umeyama: (s, R, t) minimizing sum w |dst - (s R src + t)|^2.

    Returns (T (..., 4, 4) with dst ~= s R src + t, scale (...,)).
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights[..., None]
    wsum = torch.clamp_min(torch.sum(weights, dim=-1, keepdim=True), 1e-9)[..., None]
    mu_src = torch.sum(src * w, dim=-2, keepdim=True) / wsum
    mu_dst = torch.sum(dst * w, dim=-2, keepdim=True) / wsum
    src_c = src - mu_src
    dst_c = dst - mu_dst
    cov = torch.einsum("...ni,...nj->...ij", dst_c * w, src_c) / wsum
    R = procrustes_rotation(cov)
    if with_scale:
        var_src = torch.sum(torch.sum(src_c * src_c, dim=-1) * weights, dim=-1) / wsum[..., 0, 0]
        tr = torch.einsum("...ij,...ij->...", R, cov)
        scale = tr / torch.clamp_min(var_src, 1e-12)
    else:
        scale = torch.ones(cov.shape[:-2], dtype=src.dtype, device=src.device)
    t = mu_dst[..., 0, :] - scale[..., None] * (R @ mu_src[..., 0, :, None])[..., 0]
    return rt_to_mat(scale[..., None, None] * R, t), scale


def _adj4(K: torch.Tensor) -> torch.Tensor:
    """Adjugate of a (..., 4, 4) matrix from its 3x3 minors; no divisions, so
    any finite input (singular included) gives a finite adjugate."""
    k = [[K[..., i, j] for j in range(4)] for i in range(4)]

    def det3(r0, r1, r2, c0, c1, c2):
        return (k[r0][c0] * (k[r1][c1] * k[r2][c2] - k[r1][c2] * k[r2][c1])
                - k[r0][c1] * (k[r1][c0] * k[r2][c2] - k[r1][c2] * k[r2][c0])
                + k[r0][c2] * (k[r1][c0] * k[r2][c1] - k[r1][c1] * k[r2][c0]))

    idx = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
    rows = []
    for i in range(4):           # adj[i, j] = (-1)^{i+j} minor(K del row j, col i)
        entries = []
        for j in range(4):
            r0, r1, r2 = idx[j]
            c0, c1, c2 = idx[i]
            entries.append(((-1.0) ** (i + j)) * det3(r0, r1, r2, c0, c1, c2))
        rows.append(torch.stack(entries, dim=-1))
    return torch.stack(rows, dim=-2)


def _trace(M: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


def procrustes_rotation(M: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """Rotation R maximizing tr(R^T M) for (..., 3, 3) M = sum w dst src^T."""
    t00, t01, t02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    t10, t11, t12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    t20, t21, t22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([t00 + t11 + t22, t21 - t12, t02 - t20, t10 - t01], dim=-1),
        torch.stack([t21 - t12, t00 - t11 - t22, t10 + t01, t02 + t20], dim=-1),
        torch.stack([t02 - t20, t10 + t01, t11 - t00 - t22, t21 + t12], dim=-1),
        torch.stack([t10 - t01, t02 + t20, t21 + t12, t22 - t00 - t11], dim=-1),
    ], dim=-2)
    scale = torch.sqrt(torch.sum(N * N, dim=(-2, -1), keepdim=True)) + 1e-30
    Nn = N / scale
    N2 = Nn @ Nn
    N3 = N2 @ Nn
    p2 = _trace(N2)
    p3 = _trace(N3)
    p4 = _trace(N2 @ N2)
    c2, c1, c0 = -0.5 * p2, -p3 / 3.0, 0.25 * (0.5 * p2 * p2 - p4)
    ub = torch.sqrt(torch.clamp_min(p2, 1e-30))
    lam = ub
    for _ in range(iters):
        P = ((lam * lam + c2) * lam + c1) * lam + c0
        dP = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        tiny = torch.where(dP >= 0, 1e-20, -1e-20)
        lam = lam - P / torch.where(torch.abs(dP) < 1e-20, tiny, dP)
        lam = torch.minimum(torch.clamp_min(lam, 0.0), ub)
    eye = torch.eye(4, dtype=M.dtype, device=M.device).expand(N.shape)
    A = _adj4(lam[..., None, None] * eye - Nn)
    q = torch.full(N.shape[:-1], 0.5, dtype=M.dtype, device=M.device)
    for _ in range(3):
        qn = torch.einsum("...ij,...j->...i", A, q)
        nrm = norm(qn, keepdim=True)
        q = torch.where(nrm > 1e-25, qn / torch.clamp_min(nrm, 1e-30), q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def rigid_from_three_points(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid transform from exactly 3 point pairs ((..., 3, 3)
    rows): maps an orthonormal frame of one triangle onto the other's."""

    def frame(p):
        e1 = p[..., 1, :] - p[..., 0, :]
        e2 = p[..., 2, :] - p[..., 0, :]
        u1 = e1 / torch.clamp_min(norm(e1, keepdim=True), 1e-12)
        e2p = e2 - torch.sum(e2 * u1, dim=-1, keepdim=True) * u1
        u2 = e2p / torch.clamp_min(norm(e2p, keepdim=True), 1e-12)
        u3 = torch.linalg.cross(u1, u2, dim=-1)
        return torch.stack([u1, u2, u3], dim=-1)          # (..., 3, 3) columns

    R = frame(dst) @ frame(src).transpose(-1, -2)
    c_s = torch.mean(src, dim=-2)
    c_d = torch.mean(dst, dim=-2)
    t = c_d - torch.einsum("...ij,...j->...i", R, c_s)
    return rt_to_mat(R, t)
