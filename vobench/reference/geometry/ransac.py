"""Fixed-batch RANSAC: rigid 3D-3D and essential-matrix variants (counterpart
of `sosvo/geometry/ransac.py`).

A fixed number H of hypotheses is sampled, fitted and scored in parallel,
the best is selected with argmax and refit on its inliers; no
data-dependent loop. Minimal sets are drawn WITHOUT replacement by
Gumbel-top-k over the validity mask. `jax.random` draws cannot be
reproduced in torch, so the (H, K) Gumbel matrix is an argument: callers
draw it with `gumbel` from an explicit generator, or pass the reference's
own draws in a test.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vobench.reference.geom.lie import norm, rt_to_mat, transform_points
from vobench.reference.geometry.align import rigid_from_three_points, umeyama
from vobench.reference.geometry.essential import (
    decompose_essential,
    epipolar_residual_angle,
    epipolar_residual_sin_hyps,
    fit_essential_fast,
    fit_essential_refit,
)


class RansacResult(NamedTuple):
    model: torch.Tensor        # (4, 4) rigid transform (identity when not ok)
    inliers: torch.Tensor      # (K,) bool inlier mask of the selected model
    num_inliers: torch.Tensor  # () int32
    ok: torch.Tensor           # () bool: enough inliers to trust the estimate


def gumbel_of_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel keys -log(-log(u)) of uniform draws u in [0, 1).

    u is floored at the smallest normal f32, as `jax.random.gumbel` does, so
    a draw of 0 gives a large negative key, never NaN.
    """
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))


def gumbel(gen: torch.Generator, shape: tuple[int, ...],
           device: torch.device | str) -> torch.Tensor:
    """A (H, K) Gumbel matrix drawn from `gen`."""
    return gumbel_of_uniform(torch.rand(shape, generator=gen, device=device))


def sample_minimal_sets(gumbel_hk: torch.Tensor, valid: torch.Tensor, set_size: int,
                        logits: torch.Tensor | None = None) -> torch.Tensor:
    """(H, S) distinct indices into valid slots via Gumbel-top-k.

    S argmax-and-mask passes over logit + Gumbel select the same winners, in
    the same order, as a top-k. `logits` (K,) biases the sampling; invalid
    slots get -inf.
    """
    base = torch.zeros_like(gumbel_hk[0]) if logits is None else logits
    g = torch.where(valid, base, -math.inf)[None, :] + gumbel_hk
    cols = torch.arange(g.shape[1], device=g.device)
    idxs = []
    for _ in range(set_size):
        i = torch.argmax(g, dim=-1)
        idxs.append(i)
        g = torch.where(cols[None, :] == i[:, None], -math.inf, g)
    return torch.stack(idxs, dim=-1)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim index tensor, without the host sync that indexing
    with a 0-dim CUDA tensor costs (it reads the index back)."""
    return x.index_select(0, i.reshape(1))[0]


def _select_best(residuals: torch.Tensor, valid: torch.Tensor, threshold: float):
    """Score hypotheses by masked inlier count: (best_idx, its mask, its count)."""
    inl = (residuals < threshold) & valid[None, :]
    counts = torch.sum(inl.to(torch.int32), dim=-1)
    best = torch.argmax(counts)
    return best, _take(inl, best), _take(counts, best)


def _bearing_neg_cos(T: torch.Tensor, pts_prev: torch.Tensor, rays_curr: torch.Tensor) -> torch.Tensor:
    """Negative cosine of the bearing error (monotone in the angle)."""
    pred = transform_points(T, pts_prev)
    pred = pred / torch.clamp_min(norm(pred, keepdim=True), 1e-9)
    return -torch.sum(pred * rays_curr, dim=-1)


def _bearing_neg_cos_hyps(T_h: torch.Tensor, pts_prev: torch.Tensor,
                          rays_curr: torch.Tensor) -> torch.Tensor:
    """`_bearing_neg_cos` for a whole hypothesis batch as two matmuls:
    n_hk = <R_h, ray_k (x) p_k> + t_h . ray_k and
    |R_h p_k + t_h|^2 = |p_k|^2 + |t_h|^2 + 2 (R_h^T t_h) . p_k."""
    k = pts_prev.shape[0]
    R = T_h[:, :3, :3]
    t = T_h[:, :3, 3]
    outer = rays_curr[:, :, None] * pts_prev[:, None, :]
    rhs = torch.cat([outer.reshape(k, 9), rays_curr], dim=1)    # (K, 12)
    lhs = torch.cat([R.reshape(-1, 9), t], dim=1)               # (H, 12)
    n = lhs @ rhs.T
    a = torch.einsum("hij,hi->hj", R, t)                        # R^T t
    den = (torch.sum(pts_prev * pts_prev, dim=-1)[None, :]
           + torch.sum(t * t, dim=-1)[:, None] + 2.0 * (a @ pts_prev.T))
    return -n * torch.rsqrt(torch.clamp_min(den, 1e-18))


def ransac_rigid(gumbel_hk: torch.Tensor, pts_prev: torch.Tensor, pts_curr: torch.Tensor,
                 valid: torch.Tensor, rays_curr: torch.Tensor,
                 angle_threshold: float = 0.02, min_inliers: int = 12) -> RansacResult:
    """Robust 3D-3D rigid pose T with pts_curr ~= T pts_prev, bearing-scored.

    Minimal sets of 3 triangulated pairs (sampling biased toward near points,
    logits = -log1p(depth^2)), closed-form 3-point fits, angular scoring,
    a depth-downweighted Umeyama refit on the winning inliers, and a guard
    that keeps whichever of {best hypothesis, refit} has more inliers. H is
    gumbel_hk's row count. (The reference's Euclidean-scoring variant, used
    when no rays are given, is not on the VO path and is not ported.)
    """
    depth2 = torch.sum(pts_prev * pts_prev, dim=-1)
    idx = sample_minimal_sets(gumbel_hk, valid, 3, logits=-torch.log1p(depth2))
    T_h = rigid_from_three_points(pts_prev[idx], pts_curr[idx])     # (H, 4, 4)
    # -cos(threshold) evaluated in f32, as `-jnp.cos` of a Python float is.
    thr = float(-torch.cos(torch.tensor(angle_threshold, dtype=torch.float32)))
    res = _bearing_neg_cos_hyps(T_h, pts_prev, rays_curr)
    best, inl, _ = _select_best(res, valid, thr)
    T_best = _take(T_h, best)

    # Refit on the winning inliers, mildly downweighting far points (their
    # triangulated depth error grows ~ depth^2).
    w = inl.to(pts_prev.dtype) / (1.0 + depth2)
    T_refit, _ = umeyama(pts_prev, pts_curr, weights=w)

    def inliers_of(T):
        m = (_bearing_neg_cos(T, pts_prev, rays_curr) < thr) & valid
        return m, torch.sum(m.to(torch.int32))

    inl_b, cnt_b = inliers_of(T_best)
    inl_r, cnt_r = inliers_of(T_refit)
    use_refit = cnt_r >= cnt_b
    T_sel = torch.where(use_refit, T_refit, T_best)
    inl_f = torch.where(use_refit, inl_r, inl_b)
    count_f = torch.maximum(cnt_r, cnt_b)
    ok = count_f >= min_inliers
    T_final = torch.where(ok, T_sel, torch.eye(4, dtype=T_sel.dtype, device=T_sel.device))
    return RansacResult(T_final, inl_f, count_f, ok)


def ransac_essential(gumbel_hk: torch.Tensor, rays1: torch.Tensor, rays2: torch.Tensor,
                     valid: torch.Tensor, threshold: float = 0.005, min_inliers: int = 16):
    """Robust E on the sphere -> (RansacResult, R, t_unit), 2D-2D path.

    Minimal sets of 8 ray pairs, Cholesky inverse-iteration fits, sine
    scoring, a Rayleigh-Ritz refit on the best inlier set, angular residuals
    for the final mask, and cheirality-disambiguated decomposition.
    """
    idx = sample_minimal_sets(gumbel_hk, valid, 8)
    w8 = torch.ones(idx.shape, dtype=rays1.dtype, device=rays1.device)
    E_h = fit_essential_fast(rays1[idx], rays2[idx], w8)             # (H, 3, 3)
    res = epipolar_residual_sin_hyps(E_h, rays1, rays2)
    _, inl, _ = _select_best(res, valid, threshold)
    E_refit = fit_essential_refit(rays1, rays2, inl.to(rays1.dtype))
    inl_f = (epipolar_residual_angle(E_refit, rays1, rays2) < threshold) & valid
    count_f = torch.sum(inl_f.to(torch.int32))
    ok = count_f >= min_inliers
    R, t, _ = decompose_essential(E_refit, rays1, rays2, inl_f.to(rays1.dtype))
    T_21 = rt_to_mat(R, t)
    T_final = torch.where(ok, T_21, torch.eye(4, dtype=T_21.dtype, device=T_21.device))
    return RansacResult(T_final, inl_f, count_f, ok), R, t
