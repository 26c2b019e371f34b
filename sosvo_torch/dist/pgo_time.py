"""Time-axis-sharded pose-graph optimisation (counterpart of `sosvo/dist/pgo_time.py`).

Node states are split along the trajectory: rank i of D owns the
contiguous block of n_loc = N / D keyframes [i n_loc, (i+1) n_loc). The
two edge classes travel differently:
  * odometry edges (t+1, t) stay on the rank of node t; at a block's end
    the next block's first node is the ring halo (the reference's
    `ppermute`), and what a rank computes for the next block's first node
    is the reverse halo;
  * loop edges (few, replicated, global node ids) are each handled by one
    rank (round-robin), through an all-gather of the per-node vectors and a
    sum of their contributions over the axis.
Both halos ride in the loop edges' two exchanges, which every matvec makes
anyway: the next block's first node is a row of the all-gather, and the
reverse halo is one more row of the summed buffer. So a PCG iteration costs
two exchanges and the two summed inner products.
The solver is damped Gauss-Newton with a matrix-free block-Jacobi PCG inner
solve whose inner products are summed over the axis (`_pcg` with a summed
`dot`). `_edge_jacobians`, `_pcg` and the robust kernels are the port's own
(`sosvo_torch/backend/pose_graph.py`); the loop contributions are summed
by one-hot products (`_scatter_rows`), in an order fixed by the shapes.

`pgo_solve_time_sharded` takes the whole graph on every rank (the inputs
are replicated where they come from), solves its block, and gathers the
node poses back, so every rank returns the same result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sosvo_torch.backend.pose_graph import (GAUGE_PRIOR, _edge_jacobians, _pcg, _scatter_rows,
                                            edge_residual, robust_omega, robust_rho)
from sosvo_torch.backend.schur import inv6x6_spd
from sosvo_torch.dist.mesh import Axis, Mesh
from sosvo_torch.geom.lie import se3_exp


class TimeShardedGraph(NamedTuple):
    """A pose graph laid out for time sharding. Node t lives on rank
    t // n_loc; odometry slot t constrains (t+1, t), and the last slot of
    the last block has no successor and carries w = 0. Loop edges are
    replicated and indexed by global node ids (int64)."""

    X: torch.Tensor           # (N, 4, 4) node poses (rig-from-world)
    node_valid: torch.Tensor  # (N,) bool
    T_odo: torch.Tensor       # (N, 4, 4) odometry measurements X_{t+1} X_t^-1
    w_odo: torch.Tensor       # (N,) weights; 0 = unused (the global last slot included)
    loop_i: torch.Tensor      # (E_loop,) global ids
    loop_j: torch.Tensor      # (E_loop,) global ids
    T_loop: torch.Tensor      # (E_loop, 4, 4)
    w_loop: torch.Tensor      # (E_loop,)


class TimePGOResult(NamedTuple):
    X: torch.Tensor
    cost: torch.Tensor
    cost0: torch.Tensor
    accepted: torch.Tensor


def local_block(g: TimeShardedGraph, axis: Axis) -> TimeShardedGraph:
    """This rank's time block of the node-indexed fields (views); the loop
    edges stay whole."""
    n_loc = g.X.shape[0] // axis.size
    sl = slice(axis.index * n_loc, (axis.index + 1) * n_loc)
    return g._replace(X=g.X[sl], node_valid=g.node_valid[sl], T_odo=g.T_odo[sl],
                      w_odo=g.w_odo[sl])


def _terms(X_i, X_j, T, w):
    """Per-edge weighted residuals (E, 6) and endpoint Jacobians (E, 6, 6)."""
    if X_i.shape[0] == 0:
        z = X_i.new_zeros((0, 6, 6))
        return X_i.new_zeros((0, 6)), z, z
    return torch.func.vmap(_edge_jacobians)(X_i, X_j, T, w)


def _handled_loop_weights(g: TimeShardedGraph, axis: Axis) -> torch.Tensor:
    """Loop edge e is handled by rank e mod D: w there, 0 elsewhere."""
    e = torch.arange(g.loop_i.shape[0], device=g.X.device)
    return torch.where(e % axis.size == axis.index, g.w_loop, torch.zeros_like(g.w_loop))


def _next_first(n_loc: int, axis: Axis) -> int:
    """The global id of the next block's first node (the ring wraps)."""
    return (axis.index + 1) % axis.size * n_loc


def _with_successors(local: torch.Tensor, full: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(n_loc, ...) the row after each local slot's: the ring halo, from the
    all-gathered `full`, for the last slot."""
    nxt = _next_first(local.shape[0], axis)
    return torch.cat([local[1:], full[nxt:nxt + 1]])


def _shard_terms(g: TimeShardedGraph, axis: Axis):
    """Residuals and Jacobians of this rank's odometry slots and of its
    handled loop edges (every loop edge, weight 0 where another rank
    handles it)."""
    X_full = axis.all_gather(g.X)
    odo = _terms(_with_successors(g.X, X_full, axis), g.X, g.T_odo, g.w_odo)
    loop = _terms(X_full[g.loop_i], X_full[g.loop_j], g.T_loop, _handled_loop_weights(g, axis))
    return odo, loop


def _clamp_loc(g: TimeShardedGraph, axis: Axis) -> torch.Tensor:
    """(n_loc,) gauge prior: global node 0 anchored, invalid slots clamped."""
    n_loc = g.X.shape[0]
    gids = axis.index * n_loc + torch.arange(n_loc, device=g.X.device)
    return torch.maximum((gids == 0).to(g.X.dtype), 1.0 - g.node_valid.to(g.X.dtype))


def _to_nodes(g: TimeShardedGraph, axis: Axis, odo_j, odo_i, loop_i, loop_j) -> torch.Tensor:
    """(n_loc, k) per-node sums of edge rows: odometry slot l's `odo_j[l]`
    to node l and `odo_i[l]` to node l + 1 (the last slot's to the next
    block's first node, the reverse halo), loop edge e's `loop_i[e]` to its
    i end and `loop_j[e]` to its j end. What leaves the block is summed over
    the axis in one buffer."""
    n_loc = odo_j.shape[0]
    idx = torch.cat([g.loop_i, g.loop_j,
                     torch.full((1,), _next_first(n_loc, axis), device=odo_j.device)])
    full = axis.psum(_scatter_rows(n_loc * axis.size, idx,
                                   torch.cat([loop_i, loop_j, odo_i[-1:]])))
    local = odo_j + torch.cat([torch.zeros_like(odo_i[:1]), odo_i[:-1]])
    return local + full[axis.index * n_loc:(axis.index + 1) * n_loc]


def _matvec(g, odo, loop, diag_add, axis: Axis, v_loc):
    """H v with v split along time: one all-gather (the loop edges' ends and
    the ring halo), one summed buffer (`_to_nodes`), the damping local."""
    _, Ji_o, Jj_o = odo
    _, Ji_l, Jj_l = loop
    v_full = axis.all_gather(v_loc)
    t_o = (torch.einsum("erc,ec->er", Ji_o, _with_successors(v_loc, v_full, axis))
           + torch.einsum("erc,ec->er", Jj_o, v_loc))
    t_l = (torch.einsum("erc,ec->er", Ji_l, v_full[g.loop_i])
           + torch.einsum("erc,ec->er", Jj_l, v_full[g.loop_j]))
    u = _to_nodes(g, axis, torch.einsum("erc,er->ec", Jj_o, t_o),
                  torch.einsum("erc,er->ec", Ji_o, t_o), torch.einsum("erc,er->ec", Ji_l, t_l),
                  torch.einsum("erc,er->ec", Jj_l, t_l))
    return u + diag_add[:, None] * v_loc


def _reweight(terms, robust: str, delta: float):
    """IRLS: scale (r, J_i, J_j) by sqrt(omega(||r||^2)) per edge (local)."""
    r, J_i, J_j = terms
    if robust == "none":
        return terms
    sw = torch.sqrt(robust_omega(torch.sum(r * r, dim=-1), robust, delta))
    return r * sw[:, None], J_i * sw[:, None, None], J_j * sw[:, None, None]


def _gn_step(g: TimeShardedGraph, lam, axis: Axis, cg_iters: int, robust: str = "none",
             robust_delta: float = 0.1) -> TimeShardedGraph:
    odo, loop = _shard_terms(g, axis)
    odo = _reweight(odo, robust, robust_delta)
    loop = _reweight(loop, robust, robust_delta)
    n_loc = g.X.shape[0]

    # Gradient and block-Jacobi diagonal, routed as the matvec routes: each
    # edge end's row is (J^T r, J^T J), 6 + 36 values.
    def rows(terms):
        r, J_i, J_j = terms
        return tuple(torch.cat([torch.einsum("erc,er->ec", J, r),
                                torch.einsum("eri,erj->eij", J, J).reshape(-1, 36)], dim=1)
                     for J in (J_j, J_i))

    odo_j, odo_i = rows(odo)
    loop_j, loop_i = rows(loop)
    b_D = _to_nodes(g, axis, odo_j, odo_i, loop_i, loop_j)
    b, D_blk = b_D[:, :6], b_D[:, 6:].reshape(n_loc, 6, 6)

    clamp = _clamp_loc(g, axis)
    diag_add = lam + GAUGE_PRIOR * clamp
    D_blk = D_blk + diag_add[:, None, None] * torch.eye(6, dtype=g.X.dtype, device=g.X.device)
    D_inv = inv6x6_spd(D_blk)  # inverted once, in closed form

    def dot(a, c):
        return axis.psum(torch.sum(a * c))

    delta = _pcg(lambda v: _matvec(g, odo, loop, diag_add, axis, v),
                 lambda v: torch.einsum("nij,nj->ni", D_inv, v), -b, cg_iters, dot=dot)
    delta = delta * (1.0 - clamp)[:, None]
    return g._replace(X=torch.einsum("nij,njk->nik", se3_exp(delta), g.X))


def _cost(g: TimeShardedGraph, axis: Axis, robust: str = "none",
          robust_delta: float = 0.1) -> torch.Tensor:
    """The robustified total cost, summed over the axis: each loop edge is
    weighted on exactly one rank (rho(0) = 0 elsewhere), so it counts once."""
    X_full = axis.all_gather(g.X)
    r_o = g.w_odo[:, None] * edge_residual(_with_successors(g.X, X_full, axis), g.X, g.T_odo)
    r_l = _handled_loop_weights(g, axis)[:, None] * edge_residual(
        X_full[g.loop_i], X_full[g.loop_j], g.T_loop)
    c = 0.5 * (torch.sum(robust_rho(torch.sum(r_o * r_o, dim=-1), robust, robust_delta))
               + torch.sum(robust_rho(torch.sum(r_l * r_l, dim=-1), robust, robust_delta)))
    return axis.psum(c)


def pgo_solve_time_sharded(mesh: Mesh, axis_name: str, g: TimeShardedGraph, iters: int = 10,
                           lam0: float = 1e-4, cg_iters: int = 32, robust: str = "none",
                           robust_delta: float = 0.1) -> TimePGOResult:
    """Solve the graph `g` (whole, on every rank) with its nodes split along
    time over `mesh`'s axis `axis_name`; N must divide by the axis size.
    Damped GN with accept/reject on the summed cost (lam / 3 on accept,
    x 9 on reject, clipped to [1e-9, 1e4]); `robust` / `robust_delta` as
    `pgo_solve`'s. Returns every node's pose, on every rank."""
    axis = mesh.axis(axis_name)
    if g.X.shape[0] % axis.size:
        raise ValueError(f"N={g.X.shape[0]} not divisible by axis size {axis.size}")
    loc = local_block(g, axis)
    cost0 = _cost(loc, axis, robust, robust_delta)
    lam = torch.full((), lam0, dtype=g.X.dtype, device=g.X.device)
    cost, accepted = cost0, []
    for _ in range(iters):
        cand = _gn_step(loc, lam, axis, cg_iters, robust, robust_delta)
        cand_cost = _cost(cand, axis, robust, robust_delta)
        accept = cand_cost < cost
        loc = loc._replace(X=torch.where(accept, cand.X, loc.X))
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 9.0), 1e-9, 1e4)
        cost = torch.where(accept, cand_cost, cost)
        accepted.append(accept)
    return TimePGOResult(X=axis.all_gather(loc.X), cost=cost, cost0=cost0,
                         accepted=torch.stack(accepted))
