"""Essential-matrix estimation on the sphere, batched (counterpart of
`sosvo/geometry/essential.py`).

Convention: for a point seen as ray r1 in frame 1 and r2 in frame 2, with
X2 = R X1 + t, r2^T E r1 = 0 and E = [t]_x R. Each correspondence gives a
DLT row a = vec(r2 r1^T); the fit is the smallest eigenvector of the 9x9
normal matrix, found without eigh: Cholesky inverse iteration for the
hypothesis batch, a 3-column Rayleigh-Ritz block for the refit.
"""

from __future__ import annotations

import torch

from vobench.reference.geom.lie import norm
from vobench.reference.geometry.triangulate import midpoint_triangulate


def essential_rows(rays1: torch.Tensor, rays2: torch.Tensor) -> torch.Tensor:
    """Per-correspondence DLT rows: (..., N, 9) with a = vec(r2 r1^T)."""
    outer = rays2[..., :, None] * rays1[..., None, :]
    return outer.reshape(outer.shape[:-2] + (9,))


def _normal_matrix(rays1, rays2, weights) -> torch.Tensor:
    a = essential_rows(rays1, rays2)
    return torch.einsum("...ni,...nj->...ij", a * weights[..., None], a)


def _frob(E: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(E * E, dim=(-2, -1), keepdim=True))


def _trace(M: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 determinant (cofactor expansion along the first row)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate/determinant) 3x3 inverse with a signed floor."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = (a * A + b * B + c * C)[..., None, None]
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / (det + torch.where(det >= 0, 1e-30, -1e-30))


def _chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(L L^T) X = B by two triangular solves; B: (..., 9, r)."""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


def fit_essential_fast(rays1: torch.Tensor, rays2: torch.Tensor, weights: torch.Tensor,
                       iters: int = 2) -> torch.Tensor:
    """Smallest-eigenvector fit by Cholesky inverse iteration on M + eps I.

    For RANSAC minimal sets the normal matrix has an almost exact null
    vector, which one or two inverse iterations isolate. The reference
    unrolls the batched 9x9 Cholesky into elementwise ops for the TPU; on the
    card that is some 300 launches per fit, and the library's batched
    `cholesky_ex` (no host sync, never raises) is faster
    (`sosvo_torch/tools/chol_bench.py`, PERF.md).
    """
    M = _normal_matrix(rays1, rays2, weights)
    scale = _trace(M)[..., None, None] / 9.0 + 1e-12
    eye = torch.eye(9, dtype=M.dtype, device=M.device)
    L = torch.linalg.cholesky_ex(M / scale + 1e-5 * eye).L
    v = torch.full(M.shape[:-2] + (9, 1), 1.0 / 3.0, dtype=M.dtype, device=M.device)
    for _ in range(iters):
        v = _chol_solve(L, v)
        v = v / torch.clamp_min(norm(v, dim=-2, keepdim=True), 1e-30)
    E = v.reshape(M.shape[:-2] + (3, 3))
    return E / torch.clamp_min(_frob(E), 1e-12)


def _eigvec_smallest_sym3(P: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of a symmetric 3x3, closed
    form: trigonometric eigenvalue, then the largest cross product of rows of
    (P - lam I)."""
    eye = torch.eye(3, dtype=P.dtype, device=P.device)
    q = _trace(P) / 3.0
    A = P - q[..., None, None] * eye
    p2 = torch.sum(A * A, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 1e-30))
    detB = _det3(A / p[..., None, None])
    phi = torch.arccos(torch.clamp(detB / 2.0, -1.0, 1.0)) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    B = P - lam[..., None, None] * eye
    cands = torch.stack([torch.linalg.cross(B[..., 0, :], B[..., 1, :], dim=-1),
                         torch.linalg.cross(B[..., 0, :], B[..., 2, :], dim=-1),
                         torch.linalg.cross(B[..., 1, :], B[..., 2, :], dim=-1)], dim=-2)
    best = torch.argmax(norm(cands), dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    return v / torch.clamp_min(norm(v, keepdim=True), 1e-30)


_RITZ_START = torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1],
                            [1, 0, 1], [1, -1, 0], [0, 1, -1], [1, 1, 1]],
                           dtype=torch.float32) / 3.0


def fit_essential_refit(rays1: torch.Tensor, rays2: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Exact-quality smallest-eigenvector fit of ONE normal matrix, no eigh.

    Rayleigh-Ritz: shifted-Cholesky inverse iteration on a 3-column block
    captures the span of the bottom eigenvectors even when their eigenvalues
    cluster (near pure translation), and the projected 3x3 problem separates
    them in closed form. The factorization is the library's
    `torch.linalg.cholesky_ex`, which returns without a host sync and never
    raises (the reference's `jnp.linalg.cholesky` gives NaN on failure rather
    than raising).
    """
    M = _normal_matrix(rays1, rays2, weights)
    scale = _trace(M)[..., None, None] / 9.0 + 1e-12
    Mn = M / scale
    eye = torch.eye(9, dtype=M.dtype, device=M.device)
    L = torch.linalg.cholesky_ex(Mn + 1e-5 * eye).L
    # non_blocking: the CPU constant outlives the copy, and a blocking
    # host->device copy would synchronise the stream.
    V = _RITZ_START.to(M.device, non_blocking=True).expand(M.shape[:-2] + (9, 3))
    for _ in range(2):
        V = _chol_solve(L, V)
        q0 = V[..., :, 0]
        q0 = q0 / torch.clamp_min(norm(q0, keepdim=True), 1e-30)
        q1 = V[..., :, 1] - torch.sum(q0 * V[..., :, 1], dim=-1, keepdim=True) * q0
        q1 = q1 / torch.clamp_min(norm(q1, keepdim=True), 1e-30)
        q2 = (V[..., :, 2]
              - torch.sum(q0 * V[..., :, 2], dim=-1, keepdim=True) * q0
              - torch.sum(q1 * V[..., :, 2], dim=-1, keepdim=True) * q1)
        q2 = q2 / torch.clamp_min(norm(q2, keepdim=True), 1e-30)
        V = torch.stack([q0, q1, q2], dim=-1)
    P = torch.einsum("...ir,...ij,...js->...rs", V, Mn, V)
    c = _eigvec_smallest_sym3(P)
    e = torch.einsum("...ir,...r->...i", V, c)
    E = e.reshape(e.shape[:-1] + (3, 3))
    return E / torch.clamp_min(_frob(E), 1e-12)


def _sym_pack(G: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 6) [G00, G11, G22, 2G01, 2G02, 2G12]."""
    return torch.stack([G[..., 0, 0], G[..., 1, 1], G[..., 2, 2],
                        2.0 * G[..., 0, 1], 2.0 * G[..., 0, 2], 2.0 * G[..., 1, 2]], dim=-1)


def _sym_feats(r: torch.Tensor) -> torch.Tensor:
    """(..., 3) rays -> (..., 6) with _sym_pack(G) . _sym_feats(r) == r^T G r."""
    return torch.stack([r[..., 0] * r[..., 0], r[..., 1] * r[..., 1], r[..., 2] * r[..., 2],
                        r[..., 0] * r[..., 1], r[..., 0] * r[..., 2], r[..., 1] * r[..., 2]],
                       dim=-1)


def epipolar_residual_sin_hyps(E_h: torch.Tensor, rays1: torch.Tensor,
                               rays2: torch.Tensor) -> torch.Tensor:
    """(H, K) symmetric sine residuals of a hypothesis batch, as matmuls:
    num = |<E_h, r2 (x) r1>| and the two quadratic forms r^T G r."""
    k = rays1.shape[0]
    num = torch.abs(E_h.reshape(-1, 9) @ (rays2[:, :, None] * rays1[:, None, :]).reshape(k, 9).T)
    G1 = torch.einsum("hij,hik->hjk", E_h, E_h)   # E^T E
    G2 = torch.einsum("hij,hkj->hik", E_h, E_h)   # E E^T
    d1 = _sym_pack(G1) @ _sym_feats(rays1).T
    d2 = _sym_pack(G2) @ _sym_feats(rays2).T
    s1 = num * torch.rsqrt(torch.clamp_min(d1, 1e-18))
    s2 = num * torch.rsqrt(torch.clamp_min(d2, 1e-18))
    return 0.5 * (s1 + s2)


def epipolar_residual_angle(E: torch.Tensor, rays1: torch.Tensor,
                            rays2: torch.Tensor) -> torch.Tensor:
    """Symmetric angular distance (radians) of rays from their epipolar planes."""
    Er1 = torch.einsum("...ij,...nj->...ni", E, rays1)
    Etr2 = torch.einsum("...ji,...nj->...ni", E, rays2)
    num = torch.abs(torch.sum(rays2 * Er1, dim=-1))
    s1 = num / torch.clamp_min(norm(Er1), 1e-9)
    s2 = num / torch.clamp_min(norm(Etr2), 1e-9)
    return 0.5 * (torch.arcsin(torch.clamp(s1, 0.0, 1.0)) + torch.arcsin(torch.clamp(s2, 0.0, 1.0)))


def _orthonormalize_rows(R: torch.Tensor) -> torch.Tensor:
    r0 = R[..., 0, :]
    r0 = r0 / torch.clamp_min(norm(r0, keepdim=True), 1e-30)
    r1 = R[..., 1, :] - torch.sum(r0 * R[..., 1, :], dim=-1, keepdim=True) * r0
    r1 = r1 / torch.clamp_min(norm(r1, keepdim=True), 1e-30)
    return torch.stack([r0, r1, torch.linalg.cross(r0, r1, dim=-1)], dim=-2)


def decompose_essential(E: torch.Tensor, rays1: torch.Tensor, rays2: torch.Tensor,
                        weights: torch.Tensor):
    """Recover (R, t_unit, support) from one (3, 3) E with spherical cheirality.

    t is the left null direction of E (closed-form inverse iteration on
    E E^T + eps I); R comes from Horn's cofactor identity
    2 cof(E) -/+ sqrt(2) [t]x E for the twisted pair, re-orthonormalized.
    The candidate (R, +-t) with the most positive-range triangulations wins.
    """
    G = E @ E.transpose(-1, -2)
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    eps = 1e-5 * _trace(G)[..., None, None] + 1e-20
    Ginv = _inv3x3(G + eps * eye)
    tt = torch.full(G.shape[:-1], 0.5774, dtype=E.dtype, device=E.device)
    for _ in range(3):
        tt = torch.einsum("...ij,...j->...i", Ginv, tt)
        tt = tt / torch.clamp_min(norm(tt, keepdim=True), 1e-30)
    zero = torch.zeros_like(tt[..., 0])
    tx = torch.stack([
        torch.stack([zero, -tt[..., 2], tt[..., 1]], dim=-1),
        torch.stack([tt[..., 2], zero, -tt[..., 0]], dim=-1),
        torch.stack([-tt[..., 1], tt[..., 0], zero], dim=-1),
    ], dim=-2)
    En = E / torch.clamp_min(_frob(E), 1e-30)
    c0, c1, c2 = En[..., :, 0], En[..., :, 1], En[..., :, 2]
    cross = torch.linalg.cross
    cof = torch.stack([cross(c1, c2, dim=-1), cross(c2, c0, dim=-1), cross(c0, c1, dim=-1)],
                      dim=-1)
    txE = tx @ En
    sqrt2 = 1.4142135
    Ra = _orthonormalize_rows(2.0 * cof - sqrt2 * txE)
    Rb = _orthonormalize_rows(2.0 * cof + sqrt2 * txE)

    def support_of(R, t):
        Rt = R.transpose(-1, -2)
        c2_ = -(Rt @ t[..., None])[..., 0]
        r2_in_1 = torch.einsum("...ij,...nj->...ni", Rt, rays2)
        tri = midpoint_triangulate(rays1, r2_in_1, torch.zeros_like(c2_)[..., None, :],
                                   c2_[..., None, :], min_angle=1e-4, max_range=1e6,
                                   max_gap=1e6)
        return torch.sum(weights * tri.valid.to(weights.dtype), dim=-1)

    cands = [(Ra, tt), (Ra, -tt), (Rb, tt), (Rb, -tt)]
    supports = torch.stack([support_of(R, t) for R, t in cands], dim=-1)
    best = torch.argmax(supports, dim=-1)
    cands_R = torch.stack([R for R, _ in cands], dim=-3)
    cands_t = torch.stack([t for _, t in cands], dim=-2)
    R = torch.gather(cands_R, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(cands_t, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    return R, t, torch.amax(supports, dim=-1)
