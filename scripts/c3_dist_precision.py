#!/usr/bin/env python
"""Where the PyTorch port's c3 loop-closing leg and the JAX package's part,
on tests/test_c3_dist.py's input, on the CPU.

    JAX_PLATFORMS=cpu python scripts/c3_dist_precision.py

The input is the JAX package's frame-to-frame replay of a 48-frame noisy
sequence (K=384) with 24 signature-screened candidates, 30 inliers and DCS
0.1; the port's pairs take the JAX package's per-pair draws. Prints one
JSON line per item:
  1. `edges`: the two packages' loop edges on the same keyframes: pairs
     and accepted flags equal, the largest weight and T_meas differences.
  2. `same_graph`: the port's pose graph solved by each package's
     `pgo_solve` in f32 and by the port's in float64: each f32 solve's
     largest keyframe-position distance from the float64 one, and the
     costs.
  3. `legs`: the JAX package's single-device and 8-shard legs and the
     port's single-device leg, each one's largest frame-position distance
     from the float64 leg (the port's graph solved in float64, the
     trajectory corrected in float64).
"""

import os
import sys as _sys
from pathlib import Path as _Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))

import dataclasses
import json

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import torch

from sosvo.backend import pose_graph as jpg
from sosvo.dist.c3_dist import pgo_refine_trajectory_sharded
from sosvo.dist.mesh import data_mesh
from sosvo.vo import loop_closure as jlc
from sosvo_torch.backend import pose_graph as tpg
from sosvo_torch.convert import observations_from_numpy, rig_from_numpy
from sosvo_torch.tools.reference_draws import loop_draws
from sosvo_torch.utils import config as tconfig
from sosvo_torch.vo import loop_closure as tlc
from tests.test_c3_dist import F, K, _noisy_replay

KW = dict(min_gap=3, min_inliers=30, max_candidates=24, robust="dcs")


def float64_leg(g, T_vo: torch.Tensor, kf_idx, iters: int = 10) -> torch.Tensor:
    """The port's graph `g` solved in float64 and the float64 trajectory
    `T_vo` corrected with it."""
    g64 = g._replace(X=g.X.double(), T_meas=g.T_meas.double(), w=g.w.double())
    res = tpg.pgo_solve(g64, iters=iters, robust=KW["robust"], robust_delta=0.1)
    return tlc.correct_trajectory(T_vo.double(), kf_idx, res.X)


def _positions(T) -> torch.Tensor:
    return torch.as_tensor(np.asarray(T)).double()[:, :3, 3]


def _gap(T_a, T_b) -> float:
    return float(torch.linalg.norm(_positions(T_a) - _positions(T_b), dim=-1).max())


def main() -> None:
    rig, cfg, scene, obs, outs = _noisy_replay()
    trig, tobs = rig_from_numpy(rig, "cpu"), observations_from_numpy(obs, "cpu")
    tcfg = tconfig._from_dict(tconfig.PipelineConfig, dataclasses.asdict(cfg))
    tT = torch.tensor(np.asarray(outs.T_world))
    gumbels = loop_draws(KW["max_candidates"], cfg.ransac.n_hyps, K, "cpu")
    kf = tlc.keyframe_indices(F, cfg.keyframe_every)
    port = tlc.close_loops(trig, tcfg, tobs, tT, gumbels=gumbels, **KW)
    g, n_odom = port.graph, len(kf) - 1

    obs_kf = jax.tree.map(lambda a: a[jnp.asarray(kf)], obs)
    li, lj, T_loop, w_loop = jlc.detect_loops(rig, cfg, obs_kf, KW["min_gap"], KW["min_inliers"],
                                              max_candidates=KW["max_candidates"])
    w_t, w_j = g.w[n_odom:].numpy(), np.asarray(w_loop)
    acc = w_j > 0
    print(json.dumps({
        "item": "edges", "pairs_equal": bool(np.array_equal(g.ei[n_odom:].numpy(), np.asarray(li))
                                             and np.array_equal(g.ej[n_odom:].numpy(),
                                                                np.asarray(lj))),
        "accepted_equal": bool(np.array_equal(w_t > 0, acc)), "n_loops": int(acc.sum()),
        "w_max_diff": float(np.abs(w_t - w_j).max()),
        "T_meas_max_diff": float(np.abs(g.T_meas[n_odom:].numpy()[acc]
                                        - np.asarray(T_loop)[acc]).max())}), flush=True)

    gj = jpg.PoseGraph(**{f: jnp.asarray(getattr(g, f).numpy().astype(
        np.int32 if getattr(g, f).dtype == torch.int64 else getattr(g, f).numpy().dtype))
        for f in g._fields})
    r_j = jpg.pgo_solve(gj, iters=10, robust=KW["robust"], robust_delta=0.1)
    r_t = tpg.pgo_solve(g, iters=10, robust=KW["robust"], robust_delta=0.1)
    g64 = g._replace(X=g.X.double(), T_meas=g.T_meas.double(), w=g.w.double())
    r_64 = tpg.pgo_solve(g64, iters=10, robust=KW["robust"], robust_delta=0.1)
    node = lambda X: torch.linalg.inv(torch.as_tensor(np.asarray(X)).double())  # noqa: E731
    print(json.dumps({
        "item": "same_graph", "jax_f32_vs_float64_m": _gap(node(r_j.X), node(r_64.X)),
        "port_f32_vs_float64_m": _gap(node(r_t.X), node(r_64.X)),
        "cost_jax_f32": float(r_j.cost), "cost_port_f32": float(r_t.cost),
        "cost_port_float64": float(r_64.cost)}), flush=True)

    T_64 = float64_leg(g, tT, kf)
    T_j1, _ = jlc.pgo_refine_trajectory(rig, cfg, obs, outs.T_world, **KW)
    T_j8, _ = pgo_refine_trajectory_sharded(data_mesh(8), rig, cfg, obs, outs.T_world, **KW)
    print(json.dumps({
        "item": "legs", "jax_single_vs_float64_m": _gap(T_j1, T_64),
        "jax_sharded_vs_float64_m": _gap(T_j8, T_64),
        "port_single_vs_float64_m": _gap(port.T_corrected, T_64),
        "port_single_vs_jax_single_m": _gap(port.T_corrected, T_j1),
        "port_single_vs_jax_sharded_m": _gap(port.T_corrected, T_j8),
        "jax_single_vs_jax_sharded_m": _gap(T_j1, T_j8)}), flush=True)


if __name__ == "__main__":
    main()
