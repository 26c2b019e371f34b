"""The c1 slice end to end: the port's `run_replay` against the JAX package's.

Both replay the same JAX-generated observations (K=256, 6 frames, 0.3 px
noise, 2 % bit flips) from the same start pose, and the port gets the
reference's RANSAC draws: per frame `jax.random.split(state.key, 3)` gives
(key, k_ransac, k_ess), and each RANSAC draws `jax.random.gumbel(k, (H, K))`.
Discrete outputs must agree (pose_ok, stereo and temporal match counts);
RANSAC inlier counts within +-2 (f32 rounding differs at the threshold);
positions and ATE within 1e-3 m. On CPU tensors every match goes through
the CUDA kernel's plain twin.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sosvo.eval.ate import ate_rmse as jax_ate, rpe as jax_rpe
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.synth.scene import make_scene as jax_make_scene, observe_sequence as jax_observe
from sosvo.utils.config import PipelineConfig as JaxPipelineConfig
from sosvo.utils.config import load_pipeline_config as jax_load_config
from sosvo.vo.pipeline import run_replay as jax_run_replay
from sosvo.vo.state import init_track_state as jax_init_state
from sosvo_torch.convert import observations_from_numpy, rig_from_numpy, track_state_from_numpy
from sosvo_torch.eval.ate import ate_rmse, rpe
from sosvo_torch.kernels import match_cuda
from sosvo_torch.sensor.rig import default_rig
from sosvo_torch.synth.scene import make_scene, observe_sequence
from sosvo_torch.utils.config import PipelineConfig, load_pipeline_config
from sosvo_torch.vo.pipeline import StepDraws, run_replay
from sosvo_torch.vo.state import init_track_state

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
K, FRAMES, NOISE, FLIPS = 256, 6, 0.3, 0.02


def _reference_draws(key, n_frames, n_hyps, k):
    """The Gumbel matrices the reference's replay draws, frame by frame."""
    g_rigid, g_ess = [], []
    for _ in range(n_frames):
        key, k_ransac, k_ess = jax.random.split(key, 3)
        g_rigid.append(np.asarray(jax.random.gumbel(k_ransac, (n_hyps, k))))
        g_ess.append(np.asarray(jax.random.gumbel(k_ess, (n_hyps, k))))
    return StepDraws(torch.tensor(np.stack(g_rigid)), torch.tensor(np.stack(g_ess)))


@pytest.fixture(scope="module", params=[0.9, 1.1], ids=["lazy_gate", "gate_every_frame"])
def c1_pair(request):
    """Default lazy gate, and a ratio of 1.1 that runs the essential gate on
    every frame (as tests/test_pipeline_c1.py forces it)."""
    rig = jax_default_rig()
    scene = jax_make_scene(jax.random.PRNGKey(0), n_frames=FRAMES, n_landmarks=4096)
    obs = jax_observe(rig, scene, K, jax.random.PRNGKey(1), pixel_noise=NOISE,
                      desc_flip_prob=FLIPS)
    key = jax.random.PRNGKey(2)
    state = jax_init_state(K, key, T0=scene.poses[0])
    cfg = JaxPipelineConfig(lazy_gate_ratio=request.param)
    _, ref = jax.jit(lambda s, o: jax_run_replay(rig, cfg, s, o))(state, obs)

    match_cuda.reset_launches()
    t_state = track_state_from_numpy(state, torch.Generator(), "cpu")
    draws = _reference_draws(key, FRAMES, cfg.ransac.n_hyps, K)
    _, got = run_replay(rig_from_numpy(rig, "cpu"), PipelineConfig(lazy_gate_ratio=request.param),
                        t_state, observations_from_numpy(obs, "cpu"), draws)
    return scene, ref, got


def test_replay_discrete_outputs_match(c1_pair):
    _, ref, got = c1_pair
    for name in ("pose_ok", "n_stereo", "n_temporal"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert np.asarray(ref.pose_ok)[1:].all()
    diff = np.abs(got.n_inliers.numpy().astype(int) - np.asarray(ref.n_inliers).astype(int))
    assert diff.max() <= 2, (got.n_inliers, ref.n_inliers)
    # The gate's angle (0 where the lazy gate skipped it). Near agreement it
    # is arccos of a trace within a few ulp of 3, where f32 resolves angles
    # only in steps of sqrt(2 * 2^-24) ~ 3.5e-4 rad: allow a few steps.
    np.testing.assert_allclose(got.ess_angle_err.numpy(), np.asarray(ref.ess_angle_err),
                               rtol=1e-3, atol=1e-3)


def test_replay_poses_and_ate_match(c1_pair):
    scene, ref, got = c1_pair
    pos_ref = np.asarray(ref.T_world)[:, :3, 3]
    pos_got = got.T_world.numpy()[:, :3, 3]
    assert np.abs(pos_got - pos_ref).max() < 1e-3
    gt = np.asarray(scene.poses)
    ate_ref = float(jax_ate(ref.T_world[1:, :3, 3], gt[1:, :3, 3])[0])
    ate_got = float(ate_rmse(got.T_world[1:, :3, 3], torch.tensor(gt[1:, :3, 3]))[0])
    assert abs(ate_got - ate_ref) < 1e-3, (ate_got, ate_ref)
    assert ate_got < 0.02


def test_replay_on_cpu_never_launches_the_kernel(c1_pair):
    assert match_cuda.launches == 0


def test_ate_and_rpe_match_reference():
    rng = np.random.default_rng(0)
    gt = np.asarray(jax_make_scene(jax.random.PRNGKey(3), n_frames=20).poses)
    est = gt.copy()
    est[:, :3, 3] += rng.standard_normal((20, 3)).astype(np.float32) * 0.01
    for with_scale in (False, True):
        ref = float(jax_ate(est[:, :3, 3], gt[:, :3, 3], with_scale)[0])
        got = float(ate_rmse(torch.tensor(est[:, :3, 3]), torch.tensor(gt[:, :3, 3]), with_scale)[0])
        assert abs(got - ref) < 1e-6
    ref_t, ref_r = jax_rpe(est, gt)
    got_t, got_r = rpe(torch.tensor(est), torch.tensor(gt))
    assert abs(float(got_t) - float(ref_t)) < 1e-6 and abs(float(got_r) - float(ref_r)) < 1e-5


def _port_c1(noise, flips, frames=FRAMES, seed=0):
    gen = torch.Generator().manual_seed(seed)
    rig = default_rig(device="cpu")
    scene = make_scene(gen, frames, 4096, device="cpu")
    obs = observe_sequence(rig, scene, K, gen, noise, flips)
    state = init_track_state(K, gen, T0=scene.poses[0], device="cpu")
    _, outs = run_replay(rig, PipelineConfig(), state, obs)
    return scene, outs


def test_port_noiseless_near_zero_ate():
    scene, outs = _port_c1(0.0, 0.0)
    assert bool(outs.pose_ok[1:].all())
    rmse = float(ate_rmse(outs.T_world[1:, :3, 3], scene.poses[1:, :3, 3])[0])
    assert rmse < 2e-3, rmse


def test_port_garbage_input_fails_safely():
    """Mirror of tests/test_pipeline_c1.py::test_lazy_gate_still_fails_safely_on_garbage."""
    _, outs = _port_c1(5.0, 0.45)
    assert not bool(outs.pose_ok.any())
    assert bool(torch.isfinite(outs.T_world).all())


@pytest.mark.parametrize("preset", sorted(p.name for p in (ROOT / "configs").glob("*.json")))
def test_presets_load_like_the_reference(preset):
    ref = dataclasses.asdict(jax_load_config(ROOT / "configs" / preset))
    got = dataclasses.asdict(load_pipeline_config(ROOT / "configs" / preset))
    assert got == ref
    assert json.loads((ROOT / "configs" / preset).read_text())  # valid JSON
