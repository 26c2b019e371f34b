"""Pose-graph optimisation over SE(3) edge constraints (counterpart of
`sosvo/backend/pose_graph.py`).

A fixed-size graph: N node slots, E edge slots, validity masks. Nodes store
X = rig-from-world; an edge (i, j) measures T_meas ~= X_i @ X_j^-1 and its
residual is the right-invariant log error
    r = se3_log(T_meas^-1 @ X_i @ X_j^-1)        in R^6.
Damped Gauss-Newton with accept/reject, robust (Huber, DCS) IRLS weights,
and a dense solve (the loop leg's).

Differences from the reference, all forced by eager PyTorch:
  * `lax.scan` becomes a Python loop of fixed length; accept/reject and the
    damping update are `torch.where` on the device, so `pgo_solve` never
    reads a value back to the host.
  * The per-edge Jacobians are `torch.func.jacfwd` under `torch.func.vmap`,
    as the reference's `jax.jacfwd` under `jax.vmap`: forward mode through
    the small-angle `where` guards of the log map. The residual carries a
    unit batch dimension inside the transforms: in forward mode PyTorch
    gives a 0-dim tensor combined with a Python float a float64 tangent.
  * No scatter-add: the reference's scatters into (N, N, 6, 6) blocks and
    (N, 6) rows become products with the edges' one-hot endpoint matrices
    (`build_system` forms H = J^T J from the stacked (6E, 6N) Jacobian), so
    every sum runs in an order fixed by the shapes and two calls on the
    card are bit-identical (`index_add` adds through atomics there).
  * The dense solve is `torch.linalg.solve_ex`, the library solve without
    the status read-back that `torch.linalg.solve` makes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vobench.reference.geom.lie import mat_inv, se3_exp, se3_log

GAUGE_PRIOR = 1e8


class PoseGraph(NamedTuple):
    """Fixed-size pose graph. Field meanings as in
    `sosvo.backend.pose_graph.PoseGraph`; edge endpoints are int64."""

    X: torch.Tensor           # (N, 4, 4) rig-from-world node poses
    node_valid: torch.Tensor  # (N,) bool
    ei: torch.Tensor          # (E,) edge endpoint i
    ej: torch.Tensor          # (E,) edge endpoint j
    T_meas: torch.Tensor      # (E, 4, 4) measured X_i @ X_j^-1
    w: torch.Tensor           # (E,) edge weights; 0 = unused slot


class PGOResult(NamedTuple):
    X: torch.Tensor           # (N, 4, 4) optimised poses
    cost: torch.Tensor        # () final (robustified) cost
    cost0: torch.Tensor       # () initial (robustified) cost
    accepted: torch.Tensor    # (iters,) bool per-iteration step acceptance


def edge_residual(X_i: torch.Tensor, X_j: torch.Tensor, T_meas: torch.Tensor) -> torch.Tensor:
    """(..., 6) SE(3) log of the edge error."""
    return se3_log(mat_inv(T_meas) @ X_i @ mat_inv(X_j))


def robust_omega(s2: torch.Tensor, robust: str, delta: float) -> torch.Tensor:
    """IRLS weight rho'(s2) for squared residual norms s2 (branch-free)."""
    if robust == "none":
        return torch.ones_like(s2)
    if robust == "huber":
        return torch.clamp_max(delta * torch.rsqrt(torch.clamp_min(s2, 1e-24)), 1.0)
    if robust == "dcs":
        return torch.clamp_max(2.0 * delta * delta / (delta * delta + s2), 1.0)
    raise ValueError(f"unknown robust kernel {robust!r}")


def robust_rho(s2: torch.Tensor, robust: str, delta: float) -> torch.Tensor:
    """Robustified per-edge cost rho(s2) (rho = s2 for the L2 kernel)."""
    if robust == "none":
        return s2
    if robust == "huber":
        s = torch.sqrt(torch.clamp_min(s2, 1e-24))
        return torch.where(s <= delta, s2, 2.0 * delta * s - delta * delta)
    if robust == "dcs":
        # s2 * omega * (2 - omega): the scaled residual's contribution at the
        # DCS stationary point (omega clamped at 1).
        om = torch.clamp_max(2.0 * delta * delta / (delta * delta + s2), 1.0)
        return s2 * om * (2.0 - om)
    raise ValueError(f"unknown robust kernel {robust!r}")


def _weighted_residuals(g: PoseGraph) -> torch.Tensor:
    """(E, 6) w_e r_e over all edge slots."""
    return g.w[:, None] * edge_residual(g.X[g.ei], g.X[g.ej], g.T_meas)


def _robust_edge_weight(g: PoseGraph, robust: str, delta: float) -> torch.Tensor:
    """(E,) IRLS multiplier omega(||w r||) of the robust kernel, from the
    current estimate (huber: min(1, delta/||r||); dcs: Dynamic Covariance
    Scaling, min(1, 2 delta^2 / (delta^2 + ||r||^2)))."""
    if robust == "none":
        return torch.ones_like(g.w)
    r = _weighted_residuals(g)
    return robust_omega(torch.sum(r * r, dim=-1), robust, delta)


def _robust_cost(g: PoseGraph, robust: str, delta: float) -> torch.Tensor:
    """sum_e rho(||w_e r_e||^2) / 2: the accept/reject metric (the rho-cost,
    not the reweighted quadratic of stale weights)."""
    r = _weighted_residuals(g)
    return 0.5 * torch.sum(robust_rho(torch.sum(r * r, dim=-1), robust, delta))


def _edge_jacobians(X_i, X_j, T_meas, w):
    """Weighted residual (6,) and its Jacobians (6, 6) wrt the two endpoint
    tangents at zero, for one edge (vmapped by the callers)."""

    def res(di, dj):
        # The unit batch dimension keeps every intermediate at least 1-dim
        # (see the module docstring).
        Xi = se3_exp(di[None]) @ X_i[None]
        Xj = se3_exp(dj[None]) @ X_j[None]
        r = w * edge_residual(Xi, Xj, T_meas[None])[0]
        return r, r

    zero = torch.zeros(6, dtype=X_i.dtype, device=X_i.device)
    (J_i, J_j), r = torch.func.jacfwd(res, argnums=(0, 1), has_aux=True)(zero, zero)
    return r, J_i, J_j


def _edge_terms(g: PoseGraph):
    """Per-edge weighted residuals (E, 6) and endpoint Jacobians (E, 6, 6)."""
    return torch.func.vmap(_edge_jacobians)(g.X[g.ei], g.X[g.ej], g.T_meas, g.w)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """(M, n) rows of the identity at `idx`."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def build_system(g: PoseGraph):
    """(H (N, N, 6, 6), b (N, 6), cost ()) of the GN normal equations.

    H = J^T J and b = J^T r over the stacked (6E, 6N) edge Jacobian, which
    holds J_i at node ei's six columns and J_j at ej's (the one-hot products
    place them exactly: each entry is one Jacobian entry times 1 plus zeros).
    Every block the reference scatter-adds is a sum over the same edge
    terms; here each is one matrix product, deterministic on every device."""
    N = g.X.shape[0]
    E = g.ei.shape[0]
    r, J_i, J_j = _edge_terms(g)
    J = (torch.einsum("erc,en->ernc", J_i, _one_hot(g.ei, N, J_i.dtype))
         + torch.einsum("erc,en->ernc", J_j, _one_hot(g.ej, N, J_j.dtype))).reshape(6 * E, 6 * N)
    H = (J.T @ J).reshape(N, 6, N, 6).permute(0, 2, 1, 3)
    b = (J.T @ r.reshape(6 * E, 1)).reshape(N, 6)
    cost = 0.5 * torch.sum(r * r)
    return H, b, cost


def _node_clamp(g: PoseGraph, anchor) -> torch.Tensor:
    """(N,) gauge / invalid-slot prior strength multiplier."""
    N = g.X.shape[0]
    one_hot = (torch.arange(N, device=g.X.device) == anchor).to(g.X.dtype)
    return torch.maximum(one_hot, 1.0 - g.node_valid.to(g.X.dtype))


def _apply_step(g: PoseGraph, delta: torch.Tensor, clamp: torch.Tensor) -> PoseGraph:
    delta = delta * (1.0 - clamp)[:, None]
    return g._replace(X=torch.einsum("nij,njk->nik", se3_exp(delta), g.X))


def _gn_step(g: PoseGraph, lam, anchor) -> PoseGraph:
    """One damped GN step with the dense 6N x 6N solve."""
    N = g.X.shape[0]
    H, b, _ = build_system(g)
    # Invalid node slots get the gauge prior too, so H stays nonsingular.
    clamp = _node_clamp(g, anchor)
    eye6 = torch.eye(6, dtype=g.X.dtype, device=g.X.device)
    diag = (lam + GAUGE_PRIOR * clamp)[:, None, None] * eye6
    H = H + torch.eye(N, dtype=g.X.dtype, device=g.X.device)[:, :, None, None] * diag[:, None]
    H_flat = H.permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    delta = -torch.linalg.solve_ex(H_flat, b.reshape(6 * N, 1))[0].reshape(N, 6)
    return _apply_step(g, delta, clamp)


def pgo_solve(g: PoseGraph, iters: int = 10, lam0: float = 1e-4,
              anchor: torch.Tensor | int = 0, robust: str = "none",
              robust_delta: float = 0.1) -> PGOResult:
    """Damped GN with accept/reject, a fixed iteration count, the exact
    6N x 6N solve. robust="huber" | "dcs": IRLS over edge residual norms with scale
    `robust_delta`, the weights recomputed from the current estimate every
    iteration; cost and cost0 are then the robustified objective. A step is
    kept iff it lowers the cost (lam / 3), else lam x 9, clipped to
    [1e-9, 1e4].
    """
    if robust not in ("none", "huber", "dcs"):
        raise ValueError(f"unknown robust kernel {robust!r}")
    cost0 = _robust_cost(g, robust, robust_delta)
    lam = torch.full((), lam0, dtype=g.X.dtype, device=g.X.device)
    cost = cost0
    accepted = []
    for _ in range(iters):
        gw = g
        if robust != "none":
            # IRLS: sqrt(omega) of the current estimate folded into the
            # weights for this linearisation only (g keeps the raw w).
            gw = g._replace(w=g.w * torch.sqrt(_robust_edge_weight(g, robust, robust_delta)))
        cand = _gn_step(gw, lam, anchor)
        cand_cost = _robust_cost(g._replace(X=cand.X), robust, robust_delta)
        accept = cand_cost < cost
        g = g._replace(X=torch.where(accept, cand.X, g.X))
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 9.0), 1e-9, 1e4)
        cost = torch.where(accept, cand_cost, cost)
        accepted.append(accept)
    return PGOResult(X=g.X, cost=cost, cost0=cost0, accepted=torch.stack(accepted))


def odometry_edges(X: torch.Tensor, node_valid: torch.Tensor, weight: float = 1.0):
    """Consecutive-node odometry edges from current estimates: (ei, ej, T, w)."""
    n = X.shape[0]
    ei = torch.arange(1, n, device=X.device)
    ej = torch.arange(0, n - 1, device=X.device)
    T = X[ei] @ mat_inv(X[ej])
    one = torch.ones((), dtype=X.dtype, device=X.device)
    w = torch.where(node_valid[ei] & node_valid[ej], weight * one, 0.0 * one)
    return ei, ej, T, w
