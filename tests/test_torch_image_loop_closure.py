"""Image-native loop closure (the c3 composition at test size): the port's
twin of tests/test_image_loop_closure.py, held to the JAX package's run.

24 frames of the CLI's room along the closed `make_trajectory(24,
radius=0.4)`, rendered by the JAX package at 768 px; each package extracts
its own observations (K=384, 96x768 panorama), replays frame to frame (the
port with the reference's draws), detects loops among its stride keyframes
through the signature prescreen (6 candidates, 20 inliers, min_gap 3) and
refines the trajectory with PGO (the port with the reference's per-pair
draws). Held: the JAX test's bounds on the port's own result (ATE after PGO
below 0.03 m and at most 1.5 x the VO ATE + 1e-4), pose_ok on every frame,
at least one loop edge, n_loops equal to the reference's, and the ATE
after PGO within 1e-3 m of the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sosvo.eval.ate import ate_rmse as jax_ate
from sosvo.frontend.image_frontend import build_frontend_luts, extract_observations
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.synth.render import RoomScene, render_sequence
from sosvo.synth.scene import make_trajectory as jax_make_trajectory
from sosvo.utils.config import FrontendConfig, PipelineConfig, RansacConfig
from sosvo.vo import loop_closure as jlc
from sosvo.vo.pipeline import run_replay as jax_run_replay
from sosvo.vo.state import init_track_state as jax_init_track_state
from sosvo_torch.convert import images_from_numpy, rig_from_numpy, track_state_from_numpy
from sosvo_torch.eval.ate import ate_rmse
from sosvo_torch.frontend.image_frontend import build_frontend_luts as t_build_luts
from sosvo_torch.frontend.image_frontend import extract_sequence
from sosvo_torch.utils import config as tconfig
from sosvo_torch.vo import loop_closure as tlc
from sosvo_torch.vo.pipeline import StepDraws, run_replay

torch.set_num_threads(1)
ROOM = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
FE = FrontendConfig(max_features=384, pano_height=96, pano_width=768, descriptor_patch=16)
RC = RansacConfig(rigid_angle_threshold=0.02, essential_threshold=0.01, min_inliers=8)
F = 24
LEG = dict(min_gap=3, min_inliers=20, max_candidates=6)


def _draws(key):
    g_rigid, g_ess = [], []
    for _ in range(F):
        key, k_ransac, k_ess = jax.random.split(key, 3)
        g_rigid.append(np.asarray(jax.random.gumbel(k_ransac, (RC.n_hyps, FE.max_features))))
        g_ess.append(np.asarray(jax.random.gumbel(k_ess, (RC.n_hyps, FE.max_features))))
    return StepDraws(torch.tensor(np.stack(g_rigid)), torch.tensor(np.stack(g_ess)))


def _pair_draws():
    keys = jax.random.split(jax.random.PRNGKey(tlc.LOOP_SEED), LEG["max_candidates"])
    return torch.tensor(np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (RC.n_hyps, FE.max_features)))(keys)))


def test_image_mode_loop_closure_matches_the_reference():
    rig = jax_default_rig(image_size=768)
    poses = jax_make_trajectory(F, radius=0.4)   # closed circle: real loops exist
    imgs = jax.jit(lambda P: render_sequence(rig, P, ROOM))(poses)
    cfg = PipelineConfig(frontend=FE, ransac=RC, keyframe_every=4)
    key = jax.random.PRNGKey(2)

    luts = build_frontend_luts(rig, FE)
    obs = jax.jit(jax.vmap(lambda im: extract_observations(rig, luts, FE, im)))(imgs)
    state = jax_init_track_state(FE.max_features, key, T0=poses[0])
    _, outs = jax.jit(lambda s, o: jax_run_replay(rig, cfg, s, o))(state, obs)
    T_ref, n_ref = jax.jit(lambda o, T: jlc.pgo_refine_trajectory(rig, cfg, o, T, **LEG))(
        obs, outs.T_world)
    gt = np.asarray(poses)[1:, :3, 3]
    ate_ref = float(jax_ate(T_ref[1:, :3, 3], jnp.asarray(gt))[0])

    t_rig = rig_from_numpy(rig, "cpu")
    t_cfg = tconfig._from_dict(tconfig.PipelineConfig, dataclasses.asdict(cfg))
    t_obs = extract_sequence(t_rig, t_build_luts(t_rig, t_cfg.frontend), t_cfg.frontend,
                             images_from_numpy(imgs, "cpu"))
    _, got = run_replay(t_rig, t_cfg, track_state_from_numpy(state, torch.Generator(), "cpu"),
                        t_obs, _draws(key))
    assert bool(got.pose_ok[1:].all())
    T_pgo, n_loops = tlc.pgo_refine_trajectory(t_rig, t_cfg, t_obs, got.T_world,
                                               gumbels=_pair_draws(), **LEG)
    gt_t = torch.tensor(gt)
    r_vo = float(ate_rmse(got.T_world[1:, :3, 3], gt_t)[0])
    r_pgo = float(ate_rmse(T_pgo[1:, :3, 3], gt_t)[0])
    print(f"port: n_loops {int(n_loops)} ATE {r_vo} -> {r_pgo}; "
          f"reference: n_loops {int(n_ref)} ATE after {ate_ref}")
    assert int(n_loops) >= 1 and int(n_loops) == int(n_ref)
    assert r_pgo < 0.03, r_pgo
    assert r_pgo < 1.5 * r_vo + 1e-4, (r_pgo, r_vo)
    assert abs(r_pgo - ate_ref) < 1e-3, (r_pgo, ate_ref)
