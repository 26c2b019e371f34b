"""Sharded long-trajectory loop closing (`sosvo_torch.dist.c3_dist`: pairs
split over ranks, nodes split along time) against the JAX package's and the
port's single-device leg.

tests/test_c3_dist.py's inputs: the JAX package's frame-to-frame replay of
a 48-frame noisy sequence (K=384) is the trajectory both legs refine, with
24 signature-screened candidates, 30 inliers and DCS; the port's pairs take
the JAX package's per-pair draws (`tools/reference_draws.loop_draws`).
  * 8 ranks (gloo, CPU): the same loop count as the JAX sharded leg and the
    port's single-device leg (more than 3), ATE below the replay's and at
    most 1.05 x either leg's + 1e-4, poses within 5e-3 of the port's
    single-device leg (tests/test_c3_dist.py's bounds), every rank's output
    bit-equal. Both packages are held against the float64 leg (the
    single-device leg's pose graph solved and the trajectory corrected in
    float64): the port's sharded and single-device legs' positions within
    1e-5 m, the JAX package's sharded leg's within 6e-3 m. The packages'
    loop edges agree to 5.4e-7, and the reference's f32 pose-graph solve
    is 2.1e-3 m from float64 on the same graph, its legs 5.4e-3 and
    5.8e-3 m (scripts/c3_dist_precision.py; ROADMAP.md section 3);
  * one shard (a mesh of one process, no group): the single-device leg's
    loop count, and every pose element within 1e-5 of it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sosvo.dist.c3_dist import pgo_refine_trajectory_sharded as jax_sharded
from sosvo.dist.mesh import data_mesh
from sosvo_torch.convert import observations_from_numpy, rig_from_numpy
from sosvo_torch.dist import mesh
from sosvo_torch.dist.c3_dist import pgo_refine_trajectory_sharded
from sosvo_torch.dist.launch import launch
from sosvo_torch.eval.ate import ate_rmse
from sosvo_torch.tools.reference_draws import loop_draws
from sosvo_torch.utils import config as tconfig
from sosvo_torch.backend.pose_graph import pgo_solve
from sosvo_torch.vo.loop_closure import (close_loops, correct_trajectory, keyframe_indices,
                                         pgo_refine_trajectory)
from tests.test_c3_dist import F, K, _noisy_replay

KW = dict(min_gap=3, min_inliers=30, max_candidates=24)


@pytest.fixture(scope="module")
def leg_inputs():
    rig, cfg, scene, obs, outs = _noisy_replay()
    tcfg = tconfig._from_dict(tconfig.PipelineConfig, dataclasses.asdict(cfg))
    return dict(rig=rig, cfg=cfg, obs=obs, T_vo=outs.T_world, gt=scene.poses,
                trig=rig_from_numpy(rig, "cpu"), tcfg=tcfg, tobs=observations_from_numpy(obs, "cpu"),
                tT=torch.tensor(np.asarray(outs.T_world)),
                gumbels=loop_draws(KW["max_candidates"], cfg.ransac.n_hyps, K, "cpu"))


def _ate(T, gt):
    return float(ate_rmse(torch.as_tensor(np.asarray(T))[1:, :3, 3],
                          torch.as_tensor(np.asarray(gt))[1:, :3, 3])[0])


def _pos_gap(T_a, T_b):
    return float(torch.linalg.norm(T_a[:, :3, 3].double() - T_b[:, :3, 3].double(), dim=-1).max())


def _float64_leg(g, T_vo, cfg, robust):
    """The single-device leg's pose graph solved in float64, and the
    trajectory corrected with it in float64."""
    g64 = g._replace(X=g.X.double(), T_meas=g.T_meas.double(), w=g.w.double())
    res = pgo_solve(g64, iters=10, robust=robust, robust_delta=0.1)
    return correct_trajectory(T_vo.double(), keyframe_indices(F, cfg.keyframe_every), res.X)


def test_sharded_leg_matches_jax_and_single(leg_inputs, devices8):
    x = leg_inputs
    kw = dict(KW, robust="dcs")
    T_j, n_j = jax_sharded(data_mesh(8, devices=devices8), x["rig"], x["cfg"], x["obs"],
                           x["T_vo"], **kw)
    one_device = close_loops(x["trig"], x["tcfg"], x["tobs"], x["tT"], gumbels=x["gumbels"], **kw)
    T_1, n_1 = one_device.T_corrected, one_device.n_loops
    outs = launch("tests.torch_dist_ranks:c3_sharded", 8,
                  dict(rig=x["trig"], cfg=x["tcfg"], obs=x["tobs"], T_vo=x["tT"],
                       gumbels=x["gumbels"], kwargs=kw), device="cpu", timeout_s=300)
    T_8, n_8 = outs[0]
    assert int(n_8) == int(n_j) == int(n_1) and int(n_8) > 3, (int(n_8), int(n_j), int(n_1))
    r_vo, r_1, r_8 = _ate(x["T_vo"], x["gt"]), _ate(T_1, x["gt"]), _ate(T_8, x["gt"])
    r_j = _ate(T_j, x["gt"])
    assert r_8 < r_vo and r_8 <= min(r_1, r_j) * 1.05 + 1e-4, (r_8, r_1, r_j, r_vo)
    assert _pos_gap(T_8, T_1) < 5e-3
    # against the float64 leg: the port's legs to f32 rounding, the JAX
    # package's to its f32 solve's error (ROADMAP.md section 3)
    T_64 = _float64_leg(one_device.graph, x["tT"], x["tcfg"], kw["robust"])
    gaps = _pos_gap(T_8, T_64), _pos_gap(T_1, T_64)
    assert max(gaps) < 1e-5, gaps
    assert _pos_gap(torch.as_tensor(np.asarray(T_j)), T_64) < 6e-3
    for T, n in outs[1:]:
        assert torch.equal(T, T_8) and torch.equal(n, n_8)


def test_single_shard_is_the_single_device_leg(leg_inputs):
    x = leg_inputs
    T_1, n_1 = pgo_refine_trajectory(x["trig"], x["tcfg"], x["tobs"], x["tT"],
                                     gumbels=x["gumbels"], **KW)
    one = mesh.make_mesh(mesh.single("cpu"), 1, 1)
    T_s, n_s = pgo_refine_trajectory_sharded(one, x["trig"], x["tcfg"], x["tobs"], x["tT"],
                                             gumbels=x["gumbels"], **KW)
    assert int(n_s) == int(n_1)
    # every collective is the identity: the single-device leg, to rounding
    assert float((T_s - T_1).abs().max()) < 1e-5
