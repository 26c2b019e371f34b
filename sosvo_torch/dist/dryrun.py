"""One step of every distributed path on a 2 data x 4 model layout of 8 ranks
(the port's twin of `__graft_entry__.py:dryrun_multichip`).

    python -m sosvo_torch.dist.dryrun [--ranks 8] [--device cpu]

`dist/launch.py` starts the ranks (rank = d * 4 + m). Each then runs:
  * a data-parallel VO step: sequence d (one per data row, two frames,
    K=64, H=32) tracked by the ranks of row d;
  * the landmark-sharded BA (`dist/ba_dist.py`) of a noisy W=3, L=16 window
    over the model axis, against one process's solve of it;
  * the time-sharded PGO (`dist/pgo_time.py`) of a 16-node circle (8 ranks;
    at other widths 4 nodes per rank, at least 16) with
    exact odometry and 4 loop edges and noisy starting poses, over the
    model axis, against the dense one-process solve;
  * the c5-scale BA, W=8 and L=4096 (configs/c5_multihost.json's window),
    over the model axis, against one process's solve.
Inputs come from seeded generators, alike on every rank. Prints the line
the JAX package's dryrun prints (MULTICHIP_r05.json records the
reference's: diffs 5.4e-8, 2.4e-7 and 6.0e-8 on its own inputs), and
fails if a step diverges: BA poses within 1e-4 of one process (1e-3 at c5
scale), PGO within 3e-3 of dense, every cost falling.
"""

from __future__ import annotations

import argparse
import sys

import torch

from sosvo_torch.dist import mesh as dmesh
from sosvo_torch.dist.launch import launch


def _noisy_window(gen, W: int, L: int, device, pose_noise: float):
    """A window of L scene landmarks seen by W keyframes of a scene drawn
    from `gen`: bearings with 2e-3 noise, perturbed poses and landmarks."""
    from sosvo_torch.backend.ba import BAWindow
    from sosvo_torch.geom.lie import mat_inv, se3_exp
    from sosvo_torch.sensor.model import viewpoint
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.synth.scene import make_scene

    rig = default_rig(device=device)
    scene = make_scene(gen, W, max(L, 1024), device=device)
    lms = scene.landmarks[:L]
    X = mat_inv(scene.poses[:W])
    vps = torch.stack([viewpoint(rig.top), viewpoint(rig.bottom)])
    p_rig = lms[None] @ X[:, :3, :3].transpose(-1, -2) + X[:, None, :3, 3]
    d = p_rig[:, :, None, :] - vps
    rays = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rays = rays + 2e-3 * torch.randn(rays.shape, generator=gen, device=device)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    X0 = se3_exp(pose_noise * torch.randn((W, 6), generator=gen, device=device)) @ X
    lms0 = lms + 0.01 * torch.randn(lms.shape, generator=gen, device=device)
    return BAWindow(X=X0, landmarks=lms0, rays=rays,
                    weights=torch.ones((W, L, 2), device=device), viewpoints=vps)


def _rank(ranks, data: int, model: int):
    from sosvo_torch.backend.ba import ba_solve
    from sosvo_torch.backend.pose_graph import PoseGraph, pgo_solve
    from sosvo_torch.dist.ba_dist import ba_solve_sharded
    from sosvo_torch.dist.pgo_time import TimeShardedGraph, pgo_solve_time_sharded
    from sosvo_torch.geom.lie import mat_inv, se3_exp
    from sosvo_torch.sensor.rig import default_rig
    from sosvo_torch.synth.scene import make_scene, observe_sequence
    from sosvo_torch.utils.config import PipelineConfig, RansacConfig
    from sosvo_torch.vo.pipeline import step
    from sosvo_torch.vo.state import init_track_state

    dev = ranks.device
    m = dmesh.make_mesh(ranks, data, model)
    d_axis, m_axis = m.axis(dmesh.DATA_AXIS), m.axis(dmesh.MODEL_AXIS)
    out = {}

    # data-parallel VO: sequence d on the ranks of data row d
    K = 64
    cfg = PipelineConfig(ransac=RansacConfig(n_hyps=32, min_inliers=4))
    rig = default_rig(device=dev)
    gen = torch.Generator(device=dev).manual_seed(100 + d_axis.index)
    scene = make_scene(gen, 2, 1024, device=dev)
    obs = observe_sequence(rig, scene, K, gen, pixel_noise=0.3, desc_flip_prob=0.02)
    st = init_track_state(K, torch.Generator(device=dev).manual_seed(200 + d_axis.index),
                          T0=scene.poses[0], device=dev)
    st, _ = step(rig, cfg, st, obs.frame(0))
    _, o = step(rig, cfg, st, obs.frame(1))
    ok = d_axis.all_gather(torch.stack([o.pose_ok.to(torch.int32), o.n_inliers.to(torch.int32)]
                                       )[None])
    out["vo_ok"], out["vo_inliers_min"] = int(ok[:, 0].sum()), int(ok[:, 1].min())

    # landmark-sharded BA over the model axis; 16 landmarks and 16 nodes on
    # the 4-wide model axis of 8 ranks (at least 16 at any width)
    per = 4 * max(1, 4 // model)
    gen = torch.Generator(device=dev).manual_seed(7)
    win = _noisy_window(gen, 3, per * model, dev, 0.01)
    res = ba_solve_sharded(m, win, iters=2)
    one = ba_solve(win, iters=2)
    out["ba"] = (float(res.cost0), float(res.cost), float(torch.max(torch.abs(res.X - one.X))))

    # time-sharded PGO over the model axis: a circle
    n, e_loop = per * model, 4
    ang = torch.arange(n, device=dev) * (2 * torch.pi / n)
    z = torch.zeros_like(ang)
    X_gt = se3_exp(torch.stack([z, z, ang, torch.cos(ang), torch.sin(ang),
                                0.1 * torch.sin(2 * ang)], -1))
    pert = 0.03 * torch.randn((n, 6), generator=gen, device=dev)
    pert[0] = 0.0
    Xn = se3_exp(pert) @ X_gt
    oi = torch.arange(1, n, device=dev)
    T_odo = X_gt[oi] @ mat_inv(X_gt[oi - 1])
    li = torch.arange(n // 2, n // 2 + e_loop, device=dev)
    lj = torch.arange(0, e_loop, device=dev)
    T_loop = X_gt[li] @ mat_inv(X_gt[lj])
    w_odo = torch.ones(n, device=dev)
    w_odo[n - 1] = 0.0
    g = TimeShardedGraph(X=Xn, node_valid=torch.ones(n, dtype=torch.bool, device=dev),
                         T_odo=torch.cat([T_odo, torch.eye(4, device=dev)[None]]), w_odo=w_odo,
                         loop_i=li, loop_j=lj, T_loop=T_loop, w_loop=torch.ones(e_loop, device=dev))
    pg = pgo_solve_time_sharded(m, dmesh.MODEL_AXIS, g, iters=6, cg_iters=60)
    dense = pgo_solve(PoseGraph(X=Xn, node_valid=g.node_valid, ei=torch.cat([oi, li]),
                                ej=torch.cat([oi - 1, lj]), T_meas=torch.cat([T_odo, T_loop]),
                                w=torch.ones(n - 1 + e_loop, device=dev)), iters=6)
    out["pgo"] = (float(pg.cost0), float(pg.cost), float(torch.max(torch.abs(pg.X - dense.X))), n)

    # the c5-scale window over the model axis
    win5 = _noisy_window(torch.Generator(device=dev).manual_seed(11), 8, 4096, dev, 0.005)
    res5 = ba_solve_sharded(m, win5, iters=2)
    one5 = ba_solve(win5, iters=2)
    out["c5"] = (float(res5.cost0), float(res5.cost), float(torch.max(torch.abs(res5.X - one5.X))))
    out["model_index"], out["data_index"] = m_axis.index, d_axis.index
    return out


def layout(world: int) -> tuple[int, int]:
    """(data, model): 2 x world/2 where world is even and at least 4, else 1 x world."""
    data = 2 if world >= 4 and world % 2 == 0 else 1
    return data, world // data


def dryrun(world: int = 8, device: str | None = None, timeout_s: float = 300.0) -> str:
    """Run the step on `world` ranks (`layout`); returns the printed line."""
    data, model = layout(world)
    return summarize(launch("sosvo_torch.dist.dryrun:_rank", world, dict(data=data, model=model),
                            timeout_s=timeout_s, device=device), data, model)


def summarize(outs: list, data: int, model: int) -> str:
    """The line of the ranks' results `outs` (`_rank`'s, in rank order),
    after checking them."""
    r = outs[0]
    for o in outs[1:]:  # replicated results are the same on every rank
        for key in ("ba", "pgo", "c5", "vo_ok"):
            if o[key] != r[key]:
                raise RuntimeError(f"dryrun: rank results differ on {key}: {o[key]} vs {r[key]}")
    (b0, b1, bd), (p0, p1, pd, n), (c0, c1, cd) = r["ba"], r["pgo"], r["c5"]
    checks = {"dp vo step tracked every sequence": r["vo_ok"] == data,
              "tp ba cost fell": b0 > 1e-6 and b1 < b0, "tp ba within 1e-4 of one rank": bd < 1e-4,
              "pgo cost fell": p0 > 1e-8 and p1 < p0, "pgo within 3e-3 of dense": pd < 3e-3,
              "c5 ba cost fell": c0 > 1e-6 and c1 < c0, "c5 ba within 1e-3 of one rank": cd < 1e-3}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"dryrun failed: {failed}: {r}")
    return (f"dryrun_multichip OK: mesh=({data} data x {model} model), "
            f"dp vo step ok={r['vo_ok']}/{data} inliers_min={r['vo_inliers_min']}; "
            f"tp ba cost {b0:.3e} -> {b1:.3e} (single-dev diff {bd:.1e}); "
            f"sp TIME-SHARDED pgo (ring halo, {n} nodes) cost {p0:.3e} -> {p1:.3e} "
            f"(dense diff {pd:.1e}); c5-scale ba W=8 L=4096 cost {c0:.3e} -> {c1:.3e} "
            f"(single-dev diff {cd:.1e})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sosvo_torch.dist.dryrun: no CUDA device; pass --device cpu")
    print(dryrun(args.ranks, "cpu" if args.device == "cpu" else None), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
