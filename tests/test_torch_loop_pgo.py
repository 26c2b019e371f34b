"""Loop closure and PGO over a replayed trajectory: the port's
`pgo_refine_trajectory` against the JAX package's.

The scene of tests/test_torch_loop_closure.py (F=40, K=256, H=256) is
replayed once by the JAX package, frame to frame and with keyframed window
BA (W=5, L=256, motion-adaptive keyframes, so the keyframe set is not a
stride). Both packages then close loops over the same replayed trajectory:
  * f2f: stride keyframes, all pairs, 30 inliers, the L2 kernel;
  * ba: the BA replay's own keyframes (`kf_idx`), the signature prescreen
    (16 candidates), 30 inliers, DCS with delta 0.1 (c3's settings);
with the reference's per-pair Gumbel draws. Held: n_loops equal, every
corrected position within 1e-3 m, ATE within 1e-4 m of the reference's, on
the same side of the uncorrected ATE as the reference's, and below it on
the frame-to-frame replay. On the BA replay the reference's own loop edges
are less accurate than the BA trajectory at this size (0.0090 m before, in
the JAX package 0.0254 m after, and 0.0129-0.0198 m with 60-100 inliers to
accept, or with 1 px noise: 0.066 -> 0.102 m), so PGO raises its ATE in both
packages. `sosvo_torch.tools.workload.pgo_leg` runs the same path with
a preset's settings.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sosvo.eval.ate import ate_rmse as jax_ate
from sosvo.utils.config import BAConfig
from sosvo.vo import ba_pipeline as jbp
from sosvo.vo import loop_closure as jlc
from sosvo.vo.pipeline import run_replay as jax_run_replay
from sosvo.vo.state import init_track_state as jax_init_track_state
from sosvo_torch.convert import observations_from_numpy, rig_from_numpy
from sosvo_torch.eval.ate import ate_rmse
from sosvo_torch.tools import workload
from sosvo_torch.vo import loop_closure as tlc
from tests.test_torch_loop_closure import make_cfg, port_cfg, reference_gumbels, scene_observations

torch.set_num_threads(1)
ADAPTIVE = dict(keyframe_mode="adaptive", kf_trans_thresh=0.15, kf_rot_thresh=0.15, kf_max_gap=8)
LEGS = {"f2f": dict(min_inliers=30),
        "ba": dict(min_inliers=30, max_candidates=16, robust="dcs", robust_delta=0.1)}


def _replay(case):
    """(rig, cfg, scene, obs, T_world, kf_idx or None) of the JAX replay."""
    rig, scene, obs = scene_observations()
    key = jax.random.PRNGKey(5)
    if case == "f2f":
        cfg = make_cfg()
        st = jax_init_track_state(cfg.frontend.max_features, key, T0=scene.poses[0])
        _, outs = jax.jit(lambda s, o: jax_run_replay(rig, cfg, s, o))(st, obs)
        return rig, cfg, scene, obs, outs.T_world, None
    cfg = dataclasses.replace(make_cfg(), ba=BAConfig(window=5, max_landmarks=256), **ADAPTIVE)
    st = jbp.init_ba_state(cfg, key, T0=scene.poses[0])
    _, outs = jax.jit(lambda s, o: jbp.run_replay_ba(rig, cfg, s, o))(st, obs)
    kf_idx = np.nonzero(np.asarray(outs.is_keyframe))[0]
    assert len(kf_idx) >= 8 and np.any(np.diff(kf_idx) != np.diff(kf_idx)[0]), kf_idx
    return rig, cfg, scene, obs, outs.vo.T_world, kf_idx


@pytest.fixture(scope="module", params=sorted(LEGS))
def leg(request):
    rig, cfg, scene, obs, T_vo, kf_idx = _replay(request.param)
    kw = LEGS[request.param]
    T_ref, n_ref = jlc.pgo_refine_trajectory(rig, cfg, obs, T_vo, min_gap=3, kf_idx=kf_idx, **kw)
    n_kf = len(kf_idx) if kf_idx is not None else len(jlc.keyframe_indices(obs.valid_top.shape[0],
                                                                            cfg.keyframe_every))
    n_pairs = kw.get("max_candidates") or len(jlc.loop_pairs(n_kf, 3)[0])
    t_rig, t_cfg = rig_from_numpy(rig, "cpu"), port_cfg(cfg)
    t_obs = observations_from_numpy(obs, "cpu")
    T_vo_t = torch.tensor(np.asarray(T_vo))
    T_got, n_got = tlc.pgo_refine_trajectory(t_rig, t_cfg, t_obs, T_vo_t, min_gap=3,
                                             kf_idx=kf_idx, gumbels=reference_gumbels(n_pairs),
                                             **kw)
    return dict(case=request.param, scene=scene, T_vo=np.asarray(T_vo), T_ref=np.asarray(T_ref),
                n_ref=int(n_ref), T_got=T_got, n_got=n_got, kf_idx=kf_idx, t_rig=t_rig,
                t_cfg=t_cfg, t_obs=t_obs, T_vo_t=T_vo_t)


def test_n_loops_match(leg):
    assert leg["n_got"].dtype == torch.int32 and leg["n_got"].dim() == 0
    assert int(leg["n_got"]) == leg["n_ref"]
    assert leg["n_ref"] >= 3


def test_corrected_positions_match(leg):
    d = np.linalg.norm(leg["T_got"].numpy()[:, :3, 3] - leg["T_ref"][:, :3, 3], axis=-1)
    assert d.max() < 1e-3, d.max()


def test_ate_matches_and_drops(leg):
    gt = np.asarray(leg["scene"].poses)[1:, :3, 3]
    ate_ref = float(jax_ate(leg["T_ref"][1:, :3, 3], gt)[0])
    ate_got = float(ate_rmse(leg["T_got"][1:, :3, 3], torch.tensor(gt))[0])
    ate_vo = float(jax_ate(leg["T_vo"][1:, :3, 3], gt)[0])
    assert abs(ate_got - ate_ref) < 1e-4, (ate_got, ate_ref)
    assert (ate_got < ate_vo) == (ate_ref < ate_vo), (ate_got, ate_ref, ate_vo)
    if leg["case"] == "f2f":
        assert ate_got < ate_vo, (ate_got, ate_vo)


def test_workload_leg_is_pgo_refine_trajectory(leg, monkeypatch):
    """`pgo_leg` and `pgo_refine_trajectory` are one path: `close_loops`.
    `pgo_leg` hands it the preset's loop settings as `sosvo/cli.py` passes
    them (min_gap 3, 10 iterations) and the caller's pair draws (none by
    default), and `pgo_refine_trajectory` returns its corrected poses and
    loop count."""
    kw = LEGS[leg["case"]]
    cfg = dataclasses.replace(leg["t_cfg"], loop_candidates=kw.get("max_candidates", 0),
                              loop_min_inliers=kw["min_inliers"],
                              pgo_robust=kw.get("robust", "none"),
                              pgo_robust_delta=kw.get("robust_delta", 0.1))
    kf_idx = leg["kf_idx"]
    if kf_idx is None:
        kf_idx = tlc.keyframe_indices(leg["T_vo_t"].shape[0], cfg.keyframe_every)
    calls = []

    def close_loops(*args, **kwargs):
        calls.append((args, kwargs))
        return tlc.LoopClosure(leg["T_got"], leg["n_got"], None, None)

    monkeypatch.setattr(workload, "close_loops", close_loops)
    monkeypatch.setattr(tlc, "close_loops", close_loops)
    out = workload.pgo_leg(cfg, leg["t_rig"], leg["t_obs"], leg["T_vo_t"], kf_idx)
    (args, got), = calls
    assert args == (leg["t_rig"], cfg, leg["t_obs"], leg["T_vo_t"])
    assert got == dict(min_gap=3, min_inliers=kw["min_inliers"], iters=10,
                       max_candidates=kw.get("max_candidates"), robust=kw.get("robust", "none"),
                       robust_delta=kw.get("robust_delta", 0.1), kf_idx=kf_idx, gumbels=None)
    assert out.T_corrected is leg["T_got"]
    T, n = tlc.pgo_refine_trajectory(leg["t_rig"], cfg, leg["t_obs"], leg["T_vo_t"], min_gap=3,
                                     kf_idx=kf_idx, **kw)
    assert len(calls) == 2 and T is leg["T_got"] and n is leg["n_got"]
    draws = object()   # the pairs' draws, when the caller has them, go through unchanged
    workload.pgo_leg(cfg, leg["t_rig"], leg["t_obs"], leg["T_vo_t"], kf_idx, gumbels=draws)
    assert calls[-1][1]["gumbels"] is draws
