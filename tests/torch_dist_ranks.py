"""What each rank runs in the tests of `sosvo_torch.dist` (tests/test_torch_dist_*.py).

The tests start these functions in rank processes through
`sosvo_torch.dist.launch.launch("tests.torch_dist_ranks:NAME", D, kwargs,
device="cpu")`. A rank imports torch and the port only, never jax: inputs
arrive as the port's own tensors and NamedTuples (generators replaced by
explicit draws), and results go back as tensors.
"""

from __future__ import annotations

import torch

from sosvo_torch.dist import mesh as dmesh
from sosvo_torch.dist.mesh import DATA_AXIS, MODEL_AXIS


def collectives(ranks, data: int, model: int):
    """Every helper of both axes on values that name their rank."""
    m = dmesh.make_mesh(ranks, data, model)
    r = ranks.rank
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * 0.1 + r
    y = torch.tensor(float(r) ** 0.5)
    out = {}
    for name in (MODEL_AXIS, DATA_AXIS):
        ax = m.axis(name)
        s1, s2 = ax.psum(x, y)
        out[name] = dict(size=ax.size, index=ax.index, psum=s1, psum_scalar=s2,
                         psum_one=ax.psum(x), gather=ax.all_gather(x), next=ax.from_next(x[0]),
                         prev=ax.from_prev(x[0]), bcast=ax.broadcast(x.clone() * (r + 1), 0))
    return out


def schur_shard(ranks, blocks, lam: float):
    """The shard-partial Schur reduction of rank i's landmark block; the
    inverses gathered back."""
    from sosvo_torch.kernels.schur_cuda import reduce_camera_system_cuda

    axis = dmesh.make_mesh(ranks, 1, ranks.world).axis(MODEL_AXIS)
    H_cc, H_cl, H_ll, b_c, b_l = blocks
    n = H_ll.shape[0] // axis.size
    sl = slice(axis.index * n, (axis.index + 1) * n)
    S, b_red, inv = reduce_camera_system_cuda(H_cc, H_cl[:, sl].contiguous(), H_ll[sl], b_c,
                                              b_l[sl], lam, axis=axis)
    return S, b_red, axis.all_gather(inv)


def ba_sharded(ranks, win, iters: int, huber_delta=None, data: int = 1):
    """`ba_solve_sharded` on the model axis of a (data, world / data) mesh."""
    from sosvo_torch.dist.ba_dist import ba_solve_sharded

    m = dmesh.make_mesh(ranks, data, ranks.world // data)
    dmesh.reset_calls()
    res = ba_solve_sharded(m, win, iters=iters, huber_delta=huber_delta)
    return res, dict(dmesh.calls)


def replay_sharded(ranks, rig, cfg, state, obs, draws):
    """`run_replay_ba_sharded` over all ranks (the model axis) with the given
    draws; the state's generator is unused and stands in as a fresh one."""
    from sosvo_torch.dist.replay_dist import run_replay_ba_sharded

    m = dmesh.make_mesh(ranks, 1, ranks.world)
    state = state._replace(track=state.track._replace(generator=torch.Generator()))
    dmesh.reset_calls()
    _, outs = run_replay_ba_sharded(m, rig, cfg, state, obs, draws)
    return outs, dict(dmesh.calls)


def pgo_time_sharded(ranks, g, **kw):
    """`pgo_solve_time_sharded` over all ranks (one time axis)."""
    from sosvo_torch.dist.pgo_time import pgo_solve_time_sharded

    m = dmesh.make_mesh(ranks, ranks.world, 1)
    dmesh.reset_calls()
    return pgo_solve_time_sharded(m, DATA_AXIS, g, **kw), dict(dmesh.calls)


def pgo_edge_sharded(ranks, g, **kw):
    """`pgo_solve` with rank i holding the i-th contiguous block of edges."""
    from sosvo_torch.backend.pose_graph import pgo_solve

    axis = dmesh.make_mesh(ranks, 1, ranks.world).axis(MODEL_AXIS)
    n = g.ei.shape[0] // axis.size
    sl = slice(axis.index * n, (axis.index + 1) * n)
    return pgo_solve(g._replace(ei=g.ei[sl], ej=g.ej[sl], T_meas=g.T_meas[sl], w=g.w[sl]),
                     axis=axis, **kw)


def c3_sharded(ranks, rig, cfg, obs, T_vo, gumbels, kwargs):
    """`pgo_refine_trajectory_sharded` over all ranks (one data axis)."""
    from sosvo_torch.dist.c3_dist import pgo_refine_trajectory_sharded

    m = dmesh.make_mesh(ranks, ranks.world, 1)
    return pgo_refine_trajectory_sharded(m, rig, cfg, obs, T_vo, gumbels=gumbels, **kwargs)


def batched_over_ranks(ranks, rig, cfg, obs, T0, seed: int, mode: str):
    """The batched replay with the lanes split over the data axis; every
    lane's outputs gathered back."""
    from sosvo_torch.vo import batched as tb

    m = dmesh.make_mesh(ranks, ranks.world, 1)
    S = obs.desc_top.shape[0]
    if mode == "ba":
        states = tb.init_batched_ba_states(S, cfg, seed, T0=T0, device="cpu")
        replay = tb.run_replay_ba_batched
    else:
        states = tb.init_batched_states(S, cfg.frontend.max_features, seed, T0=T0, device="cpu")
        replay = tb.run_replay_batched
    states, obs = tb.shard_batched_inputs(m, states, obs)
    final, outs = replay(rig, cfg, states, obs)
    return tb.gather_lanes(m, outs), tb.gather_lanes(m, final)


def multihost(ranks):
    """The port's twin of scripts/multihost_worker.py: a noisy window solved
    with its landmarks split over every rank, and a circle pose graph with
    its nodes split along time; rank 0 also solves both on one process."""
    from sosvo_torch.backend.ba import BAWindow, ba_solve
    from sosvo_torch.backend.pose_graph import PoseGraph, pgo_solve
    from sosvo_torch.dist.ba_dist import ba_solve_sharded
    from sosvo_torch.dist.pgo_time import TimeShardedGraph, pgo_solve_time_sharded
    from sosvo_torch.geom.lie import mat_inv, se3_exp
    from sosvo_torch.sensor.model import viewpoint
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.synth.scene import make_scene

    D = ranks.world
    W, L = 4, 64 * D
    gen = torch.Generator().manual_seed(0)  # the same window on every rank
    rig = default_rig(device="cpu")
    scene = make_scene(gen, W, L, device="cpu")
    lms = scene.landmarks[:L]
    X = mat_inv(scene.poses[:W])
    vps = torch.stack([viewpoint(rig.top), viewpoint(rig.bottom)])
    p_rig = lms[None] @ X[:, :3, :3].transpose(-1, -2) + X[:, None, :3, 3]
    d = p_rig[:, :, None, :] - vps
    rays = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rays = rays + 2e-3 * torch.randn(rays.shape, generator=gen)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    X0 = se3_exp(0.01 * torch.randn((W, 6), generator=gen)) @ X
    lms0 = lms + 0.01 * torch.randn(lms.shape, generator=gen)
    win = BAWindow(X=X0, landmarks=lms0, rays=rays, weights=torch.ones((W, L, 2)),
                   viewpoints=vps)
    res = ba_solve_sharded(dmesh.make_mesh(ranks, 1, D), win, iters=3)
    out = {"rank": ranks.rank, "world": D, "cost0": float(res.cost0), "cost": float(res.cost)}

    n, e_loop = 8 * D, 6
    ang = torch.linspace(0.0, 2 * torch.pi, n + 1)[:n]
    z = torch.zeros_like(ang)
    X_gt = se3_exp(torch.stack([z, z, ang, torch.cos(ang), torch.sin(ang),
                                0.1 * torch.sin(2 * ang)], -1))
    pert = 0.03 * torch.randn((n, 6), generator=gen)
    pert[0] = 0.0
    Xn = se3_exp(pert) @ X_gt
    T_odo = torch.cat([X_gt[1:], X_gt[:1]]) @ mat_inv(X_gt)
    w_odo = torch.ones(n)
    w_odo[n - 1] = 0.0
    li = torch.arange(n // 2, n // 2 + e_loop)
    lj = torch.arange(0, e_loop)
    T_loop = X_gt[li] @ mat_inv(X_gt[lj])
    g = TimeShardedGraph(X=Xn, node_valid=torch.ones(n, dtype=torch.bool), T_odo=T_odo,
                         w_odo=w_odo, loop_i=li, loop_j=lj, T_loop=T_loop,
                         w_loop=torch.ones(e_loop))
    res_t = pgo_solve_time_sharded(dmesh.make_mesh(ranks, D, 1), DATA_AXIS, g, iters=6,
                                   cg_iters=60)
    out.update(pgo_cost0=float(res_t.cost0), pgo_cost=float(res_t.cost))
    if ranks.rank == 0:
        ref = ba_solve(win, iters=3)
        out["x_diff_vs_single"] = float(torch.max(torch.abs(res.X - ref.X)))
        out["cost_single"] = float(ref.cost)
        dense = pgo_solve(PoseGraph(
            X=Xn, node_valid=torch.ones(n, dtype=torch.bool),
            ei=torch.cat([torch.arange(1, n), li]), ej=torch.cat([torch.arange(0, n - 1), lj]),
            T_meas=torch.cat([T_odo[:n - 1], T_loop]), w=torch.ones(n - 1 + e_loop)), iters=6)
        out["pgo_x_diff_vs_dense"] = float(torch.max(torch.abs(res_t.X - dense.X)))
    return out


def fail_on_rank_1(ranks):
    if ranks.rank == 1:
        raise ValueError("rank 1 fails")
    torch.distributed.barrier()


if __name__ == "__main__":  # a module the launcher's module form runs in each rank
    import os
    import sys
    import time

    print(f"rank {os.environ['RANK']} of {os.environ['WORLD_SIZE']}", flush=True)
    if sys.argv[1] == "--hang":
        time.sleep(600)
    sys.exit(int(sys.argv[2]))
