"""Image-mode replays: the port's `run_replay_images` (`split` True and
False) and `run_replay_images_ba` against the JAX package's image path.

Both packages get the same raw images: the CLI's room rendered by the JAX
package along `make_trajectory(F, radius=0.4)` through `default_rig(768)`,
with the JAX image tests' frontend (K=384, a 96x768 panorama) and RANSAC
settings. Each package extracts its own observations from them, with its
own LUTs (so keypoint slots may differ where two responses are within
rounding, see tests/test_torch_frontend.py), and the port replays with the
reference's random draws (as tests/test_torch_pipeline_c1.py and
test_torch_ba_pipeline.py hand them over). Held, as in those files:
pose_ok equal on every frame (is_keyframe too for BA), positions and ATE
within 1e-3 m; stereo and temporal match counts within 2 of the
reference's (a swapped slot pair can move a tie). `split=True` and `False`
must give the same outputs, bit for bit. On CPU tensors no kernel launches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.eval.ate import ate_rmse as jax_ate
from sosvo.frontend.image_frontend import build_frontend_luts, extract_observations
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.synth.render import RoomScene, render_sequence
from sosvo.synth.scene import make_trajectory as jax_make_trajectory
from sosvo.utils.config import BAConfig, FrontendConfig, PipelineConfig, RansacConfig
from sosvo.vo import ba_pipeline as jbp
from sosvo.vo.image_pipeline import run_replay_images as jax_run_replay_images
from sosvo.vo.state import init_track_state as jax_init_track_state
from sosvo_torch.convert import (ba_state_from_numpy, images_from_numpy, rig_from_numpy,
                                 track_state_from_numpy)
from sosvo_torch.eval.ate import ate_rmse
from sosvo_torch.kernels import match_cuda, schur_cuda
from sosvo_torch.utils import config as tconfig
from sosvo_torch.vo import image_pipeline as tip
from sosvo_torch.vo.pipeline import StepDraws

torch.set_num_threads(1)
ROOM = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
FE = FrontendConfig(max_features=384, pano_height=96, pano_width=768, descriptor_patch=16)
RC = RansacConfig(rigid_angle_threshold=0.02, essential_threshold=0.01, min_inliers=8)
K, H, L, F = FE.max_features, RC.n_hyps, 384, 10
RELOC_FOLD = 0x5e10c


def _port_cfg(cfg):
    return tconfig._from_dict(tconfig.PipelineConfig, dataclasses.asdict(cfg))


def _reference_draws(key, n_frames, with_reloc):
    """The Gumbel matrices the reference's replay draws, frame by frame
    (tests/test_torch_ba_pipeline.py's `_reference_draws`)."""
    g = {"rigid": [], "ess": [], "reloc": []}
    for _ in range(n_frames):
        key, k_ransac, k_ess = jax.random.split(key, 3)
        g["rigid"].append(np.asarray(jax.random.gumbel(k_ransac, (H, K))))
        g["ess"].append(np.asarray(jax.random.gumbel(k_ess, (H, K))))
        g["reloc"].append(np.asarray(jax.random.gumbel(jax.random.fold_in(key, RELOC_FOLD), (H, L))))
    names = ("rigid", "ess", "reloc") if with_reloc else ("rigid", "ess")
    return StepDraws(*(torch.tensor(np.stack(g[k])) for k in names))


@pytest.fixture(scope="module")
def world():
    rig = jax_default_rig(image_size=768)
    poses = jax_make_trajectory(F, radius=0.4)
    images = jax.jit(lambda P: render_sequence(rig, P, ROOM))(poses)
    return dict(rig=rig, poses=poses, images=images, t_rig=rig_from_numpy(rig, "cpu"),
                t_images=images_from_numpy(images, "cpu"), gt=np.asarray(poses)[1:, :3, 3])


@pytest.fixture(scope="module")
def f2f(world):
    cfg = PipelineConfig(frontend=FE, ransac=RC)
    key = jax.random.PRNGKey(2)
    state = jax_init_track_state(K, key, T0=world["poses"][0])
    luts = build_frontend_luts(world["rig"], FE)
    _, ref = jax.jit(lambda s, im: jax_run_replay_images(world["rig"], cfg, s, im, luts=luts))(
        state, world["images"])
    draws = _reference_draws(key, F, with_reloc=False)
    match_cuda.reset_launches()
    got = {split: tip.run_replay_images(world["t_rig"], _port_cfg(cfg),
                                        track_state_from_numpy(state, torch.Generator(), "cpu"),
                                        world["t_images"], split=split, draws=draws)
           for split in (True, False)}
    return dict(ref=ref, got=got, launches=match_cuda.launches)


@pytest.fixture(scope="module")
def ba(world):
    cfg = PipelineConfig(frontend=FE, ransac=RC, ba=BAConfig(max_landmarks=L, huber_delta=0.003))
    key = jax.random.PRNGKey(2)
    state = jbp.init_ba_state(cfg, key, T0=world["poses"][0])
    luts = build_frontend_luts(world["rig"], FE)
    obs = jax.jit(jax.vmap(lambda im: extract_observations(world["rig"], luts, FE, im)))(
        world["images"])
    _, ref = jax.jit(lambda s, o: jbp.run_replay_ba(world["rig"], cfg, s, o))(state, obs)
    match_cuda.reset_launches()
    schur_cuda.reset_launches()
    _, got = tip.run_replay_images_ba(world["t_rig"], _port_cfg(cfg),
                                      ba_state_from_numpy(state, torch.Generator(), "cpu"),
                                      world["t_images"], draws=_reference_draws(key, F, True))
    return dict(ref=ref, got=got, launches=(match_cuda.launches, schur_cuda.launches))


def test_split_and_fused_replays_are_equal(f2f):
    (_, a), (_, b) = f2f["got"][True], f2f["got"][False]
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def _check_vo(ref, got, gt):
    np.testing.assert_array_equal(got.pose_ok.numpy(), np.asarray(ref.pose_ok))
    assert np.asarray(ref.pose_ok)[1:].all()
    for name in ("n_stereo", "n_temporal"):
        d = np.abs(getattr(got, name).numpy().astype(int) - np.asarray(getattr(ref, name)).astype(int))
        assert d.max() <= 2, (name, getattr(got, name), getattr(ref, name))
    pos_ref = np.asarray(ref.T_world)[:, :3, 3]
    assert np.abs(got.T_world.numpy()[:, :3, 3] - pos_ref).max() < 1e-3
    ate_ref = float(jax_ate(jnp.asarray(pos_ref[1:]), jnp.asarray(gt))[0])
    ate_got = float(ate_rmse(got.T_world[1:, :3, 3], torch.tensor(gt))[0])
    print(f"ATE port {ate_got} reference {ate_ref}")
    assert abs(ate_got - ate_ref) < 1e-3 and ate_got < 0.02


def test_image_replay_matches(world, f2f):
    _check_vo(f2f["ref"], f2f["got"][True][1], world["gt"])


def test_image_ba_replay_matches(world, ba):
    ref, got = ba["ref"], ba["got"]
    np.testing.assert_array_equal(got.is_keyframe.numpy(), np.asarray(ref.is_keyframe))
    assert np.asarray(ref.is_keyframe).sum() >= 3
    assert not got.reloc_tried.numpy().any()
    _check_vo(ref.vo, got.vo, world["gt"])


def test_cpu_image_replays_never_launch_a_kernel(f2f, ba):
    assert f2f["launches"] == 0 and ba["launches"] == (0, 0)


def test_image_step_ba_is_step_ba_on_extracted_observations(world):
    """One BA frame from an image equals `step_ba` on its extracted observations."""
    from sosvo_torch.frontend.image_frontend import build_frontend_luts as t_luts
    from sosvo_torch.frontend.image_frontend import extract_observations as t_extract
    from sosvo_torch.vo.ba_pipeline import init_ba_state, step_ba

    cfg = _port_cfg(PipelineConfig(frontend=FE, ransac=RC,
                                   ba=BAConfig(max_landmarks=L, huber_delta=0.003)))
    luts = t_luts(world["t_rig"], cfg.frontend)
    T0 = torch.tensor(np.asarray(world["poses"][0]))
    outs = []
    for fn in (lambda s: tip.image_step_ba(world["t_rig"], luts, cfg, s, world["t_images"][0], 0, 0),
               lambda s: step_ba(world["t_rig"], cfg, s,
                                 t_extract(world["t_rig"], luts, cfg.frontend, world["t_images"][0]),
                                 0, 0)):
        state = init_ba_state(cfg, torch.Generator().manual_seed(3), T0=T0, device="cpu")
        outs.append(fn(state))
    (sa, oa, na), (sb, ob, nb) = outs
    assert na == nb == 1
    assert torch.equal(oa.vo.T_world, ob.vo.T_world) and torch.equal(sa.map.lm_pos, sb.map.lm_pos)
