"""Long-trajectory loop closing, sharded end to end (counterpart of
`sosvo/dist/c3_dist.py`; the c3_long presets).

    keyframes -> signature prescreen (alike on every rank)
              -> candidate pairs split over the ranks (match, RANSAC, BA)
              -> keyframe nodes split along time (odometry halos, loop
                 edges gathered and summed)
              -> every frame corrected rigidly with its governing keyframe

The sharded twin of `sosvo_torch.vo.loop_closure.pgo_refine_trajectory`:
`dist/loops_dist.py` evaluates the pairs, `dist/pgo_time.py` solves the
graph, both over `mesh`'s data axis. The keyframe count is padded to a
multiple of the axis size with clamped invalid nodes. The replay that
produced the trajectory runs once (the command line runs it on rank 0 and
broadcasts the keyframes' observations and the trajectory); this leg takes
them on every rank.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sosvo_torch.dist.loops_dist import detect_loops_sharded
from sosvo_torch.dist.mesh import DATA_AXIS, Mesh
from sosvo_torch.dist.pgo_time import TimeShardedGraph, pgo_solve_time_sharded
from sosvo_torch.geom.lie import mat_inv
from sosvo_torch.sensor.rig import OmnistereoRig
from sosvo_torch.synth.scene import FrameObservations
from sosvo_torch.utils.config import PipelineConfig
from sosvo_torch.vo.loop_closure import correct_trajectory, keyframe_indices


def time_sharded_graph(X_kf: torch.Tensor, shards: int, odom_weight: float, li, lj, T_loop,
                       w_loop) -> TimeShardedGraph:
    """The keyframe graph in time-sharded layout, padded to a multiple of
    `shards` nodes (identity poses, invalid); odometry slot t constrains
    (t+1, t) with X_{t+1} X_t^-1, and the last real keyframe's slot and
    every padding slot carry w = 0."""
    n_kf = X_kf.shape[0]
    pad = -(-n_kf // shards) * shards - n_kf
    dev = X_kf.device
    X = torch.cat([X_kf, torch.eye(4, dtype=X_kf.dtype, device=dev).expand(pad, 4, 4)])
    n = X.shape[0]
    node_valid = torch.arange(n, device=dev) < n_kf
    T_odo = torch.cat([X[1:], X[:1]]) @ mat_inv(X)
    w_odo = torch.where(torch.arange(n, device=dev) < n_kf - 1,
                        torch.full((), odom_weight, dtype=X.dtype, device=dev),
                        torch.zeros((), dtype=X.dtype, device=dev))
    return TimeShardedGraph(X=X, node_valid=node_valid, T_odo=T_odo, w_odo=w_odo,
                            loop_i=li.to(torch.int64), loop_j=lj.to(torch.int64),
                            T_loop=T_loop, w_loop=w_loop)


def refine_keyframes_sharded(mesh: Mesh, rig: OmnistereoRig, cfg: PipelineConfig,
                             obs_kf: FrameObservations, T_world_seq: torch.Tensor,
                             kf_idx: np.ndarray, min_gap: int = 3, min_inliers: int = 30,
                             iters: int = 10, odom_weight: float = 1.0,
                             max_candidates: int | None = None, robust: str = "none",
                             robust_delta: float = 0.1, generator: torch.Generator | None = None,
                             gumbels: Sequence[torch.Tensor] | None = None):
    """The leg from the keyframes' observations `obs_kf` (frames `kf_idx` of
    `T_world_seq`): (corrected poses (F, 4, 4), n_loops), the same on every
    rank."""
    kf = torch.as_tensor(np.asarray(kf_idx), dtype=torch.int64).to(T_world_seq.device)
    li, lj, T_loop, w_loop = detect_loops_sharded(mesh, rig, cfg, obs_kf, min_gap, min_inliers,
                                                  max_candidates, generator, gumbels)
    g = time_sharded_graph(mat_inv(T_world_seq[kf]), mesh.axis(DATA_AXIS).size, odom_weight,
                           li, lj, T_loop, w_loop)
    res = pgo_solve_time_sharded(mesh, DATA_AXIS, g, iters=iters, robust=robust,
                                 robust_delta=robust_delta)
    T_corrected = correct_trajectory(T_world_seq, kf_idx, res.X[:kf.shape[0]])
    return T_corrected, torch.sum(w_loop > 0, dtype=torch.int32)


def pgo_refine_trajectory_sharded(mesh: Mesh, rig: OmnistereoRig, cfg: PipelineConfig,
                                  obs_seq: FrameObservations, T_world_seq: torch.Tensor,
                                  min_gap: int = 3, min_inliers: int = 30, iters: int = 10,
                                  odom_weight: float = 1.0, max_candidates: int | None = None,
                                  robust: str = "none", robust_delta: float = 0.1,
                                  kf_idx: np.ndarray | None = None,
                                  generator: torch.Generator | None = None,
                                  gumbels: Sequence[torch.Tensor] | None = None):
    """Sharded twin of `pgo_refine_trajectory` (the same arguments and a
    mesh): (corrected poses, n_loops)."""
    if kf_idx is None:
        kf_idx = keyframe_indices(T_world_seq.shape[0], cfg.keyframe_every)
    kf = torch.as_tensor(np.asarray(kf_idx), dtype=torch.int64).to(T_world_seq.device)
    obs_kf = FrameObservations(*(x[kf] for x in obs_seq))
    return refine_keyframes_sharded(mesh, rig, cfg, obs_kf, T_world_seq, kf_idx, min_gap,
                                    min_inliers, iters, odom_weight, max_candidates, robust,
                                    robust_delta, generator, gumbels)
