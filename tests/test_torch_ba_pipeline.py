"""The BA slice end to end: the port's `run_replay_ba` against the JAX package's.

Both replay the same JAX-generated observations (K=256, H=256 hypotheses,
a W=5 window over L=256 landmark slots, 24 frames, 0.3 px noise, 2 % bit
flips) from the same state, carried across by `sosvo_torch.convert`, and the
port gets the reference's random draws: per frame `jax.random.split(key, 3)`
gives (key, k_ransac, k_ess), each RANSAC draws `jax.random.gumbel(k, (H, K))`,
and relocalisation draws `jax.random.gumbel(jax.random.fold_in(key, 0x5e10c),
(H, L))` from the key after that split. Discrete outputs must be equal
(keyframes, pose_ok, landmark and match counts); RANSAC inlier counts within
+-2 (as the c1 test allows); positions and ATE within 1e-3 m; the BA cost
within 1e-3 relative. Cases: a clean sequence, a sensor dropout that makes
relocalisation run (tests/test_reloc.py's), and motion-adaptive keyframes.
On CPU tensors neither kernel launches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.eval.ate import ate_rmse as jax_ate
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.synth.scene import make_scene as jax_make_scene, observe_sequence as jax_observe
from sosvo.utils.config import BAConfig, FrontendConfig, PipelineConfig, RansacConfig
from sosvo.vo import ba_pipeline as jbp
from sosvo.vo import keyframes as jkf
from sosvo.vo.pipeline import stereo_triangulate as jax_stereo_triangulate
from sosvo.vo.state import StepOutput as JaxStepOutput
from sosvo_torch.convert import (
    ba_state_from_numpy,
    desc_to_numpy,
    desc_to_torch,
    map_state_from_numpy,
    observations_from_numpy,
    rig_from_numpy,
    track_state_from_numpy,
)
from sosvo_torch.eval.ate import ate_rmse
from sosvo_torch.kernels import match_cuda, schur_cuda
from sosvo_torch.utils import config as tconfig
from sosvo_torch.vo import ba_pipeline as tbp
from sosvo_torch.vo import keyframes as tkf
from sosvo_torch.vo.pipeline import StepDraws, run_replay
from sosvo_torch.vo.state import KeyframeFeatures, StepOutput, init_track_state

torch.set_num_threads(1)
K, H, WIN, L, F = 256, 256, 5, 256, 24
DROP = slice(8, 13)  # frames with dead descriptors (tests/test_reloc.py's dropout)
RELOC_FOLD = 0x5e10c
ADAPTIVE = dict(keyframe_mode="adaptive", kf_trans_thresh=0.15, kf_rot_thresh=0.15,
                kf_max_gap=8)


def _cfg(**kw):
    return PipelineConfig(frontend=FrontendConfig(max_features=K), ransac=RansacConfig(n_hyps=H),
                          ba=BAConfig(window=WIN, max_landmarks=L), **kw)


def _port_cfg(cfg):
    """The same preset, as the port's dataclasses."""
    return tconfig._from_dict(tconfig.PipelineConfig, dataclasses.asdict(cfg))


def _reference_draws(key, n_frames):
    """The Gumbel matrices the reference's BA replay draws, frame by frame."""
    g = {"rigid": [], "ess": [], "reloc": []}
    for _ in range(n_frames):
        key, k_ransac, k_ess = jax.random.split(key, 3)
        g["rigid"].append(np.asarray(jax.random.gumbel(k_ransac, (H, K))))
        g["ess"].append(np.asarray(jax.random.gumbel(k_ess, (H, K))))
        g["reloc"].append(np.asarray(jax.random.gumbel(jax.random.fold_in(key, RELOC_FOLD), (H, L))))
    return StepDraws(*(torch.tensor(np.stack(g[k])) for k in ("rigid", "ess", "reloc")))


def _sequence(dropout):
    rig = jax_default_rig()
    scene = jax_make_scene(jax.random.PRNGKey(0), n_frames=F, n_landmarks=4096)
    obs = jax_observe(rig, scene, K, jax.random.PRNGKey(1), pixel_noise=0.3, desc_flip_prob=0.02)
    if dropout:  # descriptors die in both views while the rig keeps moving
        kd = jax.random.PRNGKey(7)
        shape = obs.desc_top[DROP].shape
        obs = obs._replace(
            desc_top=obs.desc_top.at[DROP].set(
                jax.random.randint(kd, shape, 0, 2**31 - 1, jnp.int32).astype(jnp.uint32)),
            desc_bottom=obs.desc_bottom.at[DROP].set(
                jax.random.randint(jax.random.fold_in(kd, 1), shape, 0, 2**31 - 1,
                                   jnp.int32).astype(jnp.uint32)))
    return rig, scene, obs


_JIT = {}


def _jax_replay(rig, cfg, state, obs):
    """One compiled reference replay per configuration."""
    if cfg not in _JIT:
        _JIT[cfg] = jax.jit(lambda s, o: jbp.run_replay_ba(rig, cfg, s, o))
    return _JIT[cfg](state, obs)


def _run_pair(dropout, **cfg_kw):
    cfg = _cfg(**cfg_kw)
    rig, scene, obs = _sequence(dropout)
    key = jax.random.PRNGKey(2)
    state = jbp.init_ba_state(cfg, key, T0=scene.poses[0])
    ref_final, ref = _jax_replay(rig, cfg, state, obs)

    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    t_state = ba_state_from_numpy(state, torch.Generator(), "cpu")
    got_final, got = tbp.run_replay_ba(rig_from_numpy(rig, "cpu"), _port_cfg(cfg), t_state,
                                       observations_from_numpy(obs, "cpu"),
                                       _reference_draws(key, F))
    launches = (match_cuda.launches, schur_cuda.launches)
    return dict(cfg=cfg, rig=rig, scene=scene, obs=obs, ref=ref, got=got, ref_final=ref_final,
                got_final=got_final, launches=launches)


@pytest.fixture(scope="module", params=["clean", "dropout", "adaptive"])
def pair(request):
    kw = ADAPTIVE if request.param == "adaptive" else {}
    return dict(_run_pair(request.param == "dropout", **kw), case=request.param)


def test_discrete_outputs_match(pair):
    ref, got = pair["ref"], pair["got"]
    for name in ("is_keyframe", "n_landmarks"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("pose_ok", "n_stereo", "n_temporal"):
        np.testing.assert_array_equal(getattr(got.vo, name).numpy(),
                                      np.asarray(getattr(ref.vo, name)), err_msg=name)
    diff = np.abs(got.vo.n_inliers.numpy().astype(int) - np.asarray(ref.vo.n_inliers).astype(int))
    assert diff.max() <= 2, (got.vo.n_inliers, ref.vo.n_inliers)
    assert np.asarray(ref.is_keyframe).sum() >= 4  # BA ran several times


def test_poses_ate_and_ba_cost_match(pair):
    ref, got, scene = pair["ref"], pair["got"], pair["scene"]
    pos_ref = np.asarray(ref.vo.T_world)[:, :3, 3]
    pos_got = got.vo.T_world.numpy()[:, :3, 3]
    assert np.abs(pos_got - pos_ref).max() < 1e-3
    gt = np.asarray(scene.poses)
    ate_ref = float(jax_ate(ref.vo.T_world[1:, :3, 3], gt[1:, :3, 3])[0])
    ate_got = float(ate_rmse(got.vo.T_world[1:, :3, 3], torch.tensor(gt[1:, :3, 3]))[0])
    assert abs(ate_got - ate_ref) < 1e-3, (ate_got, ate_ref)
    np.testing.assert_allclose(got.ba_cost.numpy(), np.asarray(ref.ba_cost), rtol=1e-3, atol=1e-9)
    assert (np.asarray(ref.ba_cost) > 0).sum() >= 3


def test_final_maps_match(pair):
    """The map the replay leaves behind holds the same landmarks with the
    same staleness and observations, at close positions.

    Landmarks are paired by descriptor, not by slot: new landmarks go to
    slots in the order of their candidate score 1/(1 + depth^2), and two
    far points' triangulated depths can differ between the packages by
    ~1e-3 relative (f32 midpoint triangulation at small ray angles), enough
    to swap two near-equal candidates and so their slots (the dropout
    sequence has one such pair). BA is indifferent to slot order."""
    ref, got = pair["ref_final"].map, pair["got_final"].map
    for name in ("kf_valid", "kf_frame", "head", "n_kf"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.kf_X.numpy(), np.asarray(ref.kf_X), rtol=0, atol=1e-3)
    valid = np.asarray(ref.lm_valid)
    np.testing.assert_array_equal(np.sort(got.lm_valid.numpy()), np.sort(valid))
    slot_of = {bytes(d): i for i, d in enumerate(np.asarray(ref.lm_desc)) if valid[i]}
    got_desc, got_valid = desc_to_numpy(got.lm_desc), got.lm_valid.numpy()
    perm = np.array([slot_of[bytes(d)] for d, v in zip(got_desc, got_valid) if v])
    rows = np.flatnonzero(got_valid)
    assert len(set(perm)) == valid.sum() and (rows == perm).mean() > 0.95
    np.testing.assert_array_equal(got.lm_last_seen.numpy()[rows], np.asarray(ref.lm_last_seen)[perm])
    np.testing.assert_array_equal(got.obs_w.numpy()[:, rows], np.asarray(ref.obs_w)[:, perm])
    np.testing.assert_allclose(got.obs_rays.numpy()[:, rows], np.asarray(ref.obs_rays)[:, perm],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.lm_pos.numpy()[rows], np.asarray(ref.lm_pos)[perm],
                               rtol=0, atol=1e-2)


def test_relocalisation_runs_where_tracking_was_lost(pair):
    """Relocalisation runs exactly on the dropout's lost frames and
    re-acquires the absolute pose after it (tests/test_reloc.py's claims, on
    the port's replay); on the other sequences it never runs."""
    got = pair["got"]
    tried = got.reloc_tried.numpy()
    ok = got.vo.pose_ok.numpy()
    if pair["case"] != "dropout":
        assert not tried.any() and ok[1:].all()
        return
    assert ok[1:8].all() and not ok[9:13].any() and ok[14:].all()
    assert not tried[:8].any() and tried[9:13].all()
    est = got.vo.T_world.numpy()[14:, :3, 3]
    gt = np.asarray(pair["scene"].poses)[14:, :3, 3]
    assert float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1)))) < 0.05


def test_cpu_replay_never_launches_a_kernel(pair):
    assert pair["launches"] == (0, 0)


def _port_feats(feats):
    return KeyframeFeatures(pts_rig=torch.tensor(np.asarray(feats.pts_rig)),
                            desc=desc_to_torch(feats.desc, "cpu"),
                            ray_top=torch.tensor(np.asarray(feats.ray_top)),
                            ray_bottom=torch.tensor(np.asarray(feats.ray_bottom)),
                            valid=torch.tensor(np.asarray(feats.valid)))


def test_insert_keyframe_matches():
    """One keyframe insertion into a full, recycling map (association,
    eviction, new landmarks), from the same map and features."""
    cfg = _cfg()
    rig, scene, obs = _sequence(False)
    state = jbp.init_ba_state(cfg, jax.random.PRNGKey(2), T0=scene.poses[0])
    final, _ = _jax_replay(rig, cfg, state, obs)
    frame = jax.tree.map(lambda x: x[F - 1], obs)
    pts, desc, rays, _, valid, ray_b = jax_stereo_triangulate(rig, frame, cfg)
    feats = jkf.KeyframeFeatures(pts_rig=pts, desc=desc, ray_top=rays, ray_bottom=ray_b,
                                 valid=valid)
    T = scene.poses[F - 1]
    ref = jax.jit(lambda m, T, f: jkf.insert_keyframe(m, T, f, jnp.int32(F - 1),
                                                      max_new=cfg.ba.max_new))(final.map, T, feats)
    got = tkf.insert_keyframe(map_state_from_numpy(final.map, "cpu"), torch.tensor(np.asarray(T)),
                              _port_feats(feats), torch.tensor(F - 1, dtype=torch.int32),
                              max_new=cfg.ba.max_new)
    assert int(np.asarray(ref.lm_valid).sum()) == L
    for name in ("kf_valid", "kf_frame", "head", "n_kf", "lm_valid", "lm_last_seen", "obs_w"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(desc_to_numpy(got.lm_desc), np.asarray(ref.lm_desc))
    for name in ("kf_X", "lm_pos", "obs_rays"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert int(tkf.window_anchor(got)) == int(jkf.window_anchor(ref))


def test_try_relocalize_matches():
    """A lost frame re-acquired against the same map with the same draw."""
    cfg = _cfg()
    rig, scene, obs = _sequence(False)
    state = jbp.init_ba_state(cfg, jax.random.PRNGKey(2), T0=scene.poses[0])
    final, _ = _jax_replay(rig, cfg, state, obs)
    frame = jax.tree.map(lambda x: x[F - 2], obs)
    pts, desc, rays, _, valid, ray_b = jax_stereo_triangulate(rig, frame, cfg)
    feats = jkf.KeyframeFeatures(pts_rig=pts, desc=desc, ray_top=rays, ray_bottom=ray_b,
                                 valid=valid)
    lost = JaxStepOutput(T_world=final.track.T_world, n_stereo=jnp.int32(0),
                         n_temporal=jnp.int32(0), n_inliers=jnp.int32(0),
                         pose_ok=jnp.asarray(False), ess_angle_err=jnp.float32(0.0))
    ref_track, ref_out = jbp.try_relocalize(cfg, final.map, final.track, lost, feats)
    g = torch.tensor(np.asarray(jax.random.gumbel(
        jax.random.fold_in(final.track.key, RELOC_FOLD), (H, L))))
    t_out = StepOutput(*(torch.tensor(np.asarray(x)) for x in lost))
    got_track, got_out = tbp.try_relocalize(
        _port_cfg(cfg), map_state_from_numpy(final.map, "cpu"),
        track_state_from_numpy(final.track, torch.Generator(), "cpu"), t_out,
        _port_feats(feats), g)
    assert bool(ref_out.pose_ok) and bool(got_out.pose_ok)
    assert abs(int(got_out.n_inliers) - int(ref_out.n_inliers)) <= 2
    np.testing.assert_allclose(got_track.T_world.numpy(), np.asarray(ref_track.T_world),
                               rtol=0, atol=1e-4)
    # Recovered the frame's true pose, not the lost one's.
    assert np.abs(got_track.T_world.numpy()[:3, 3] - np.asarray(scene.poses[F - 2])[:3, 3]).max() < 0.05


def test_ba_beats_frame_to_frame():
    """tests/test_ba_pipeline.py's invariant on the port alone: on the same
    sequence the BA replay's ATE is below the frame-to-frame replay's."""
    rig, scene, obs = _sequence(False)
    t_rig, t_obs = rig_from_numpy(rig, "cpu"), observations_from_numpy(obs, "cpu")
    cfg = _port_cfg(_cfg())
    gt = torch.tensor(np.asarray(scene.poses)[1:, :3, 3])
    T0 = torch.tensor(np.asarray(scene.poses[0]))
    _, o_f2f = run_replay(t_rig, cfg, init_track_state(K, torch.Generator().manual_seed(2), T0,
                                                       device="cpu"), t_obs)
    state = tbp.init_ba_state(cfg, torch.Generator().manual_seed(2), T0, device="cpu")
    _, o_ba = tbp.run_replay_ba(t_rig, cfg, state, t_obs)
    r_f2f = float(ate_rmse(o_f2f.T_world[1:, :3, 3], gt)[0])
    r_ba = float(ate_rmse(o_ba.vo.T_world[1:, :3, 3], gt)[0])
    assert bool(o_ba.vo.pose_ok[1:].all())
    assert r_ba < r_f2f, (r_ba, r_f2f)
    assert int(o_ba.is_keyframe.sum()) == (F + cfg.keyframe_every - 1) // cfg.keyframe_every
