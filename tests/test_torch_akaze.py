"""The AKAZE descriptor option: `sosvo_torch.frontend.akaze` and AKAZE
extraction and replay against the JAX package's `sosvo.frontend.akaze`.

Inputs: numpy-seeded arrays, and the CLI's room rendered by the JAX package
through `default_rig(768)` with tests/test_akaze.py's frontend (K=384, a
96x768 panorama, 16 px patches), warped by the JAX package on its LUTs.

Tolerances, and what sets them:
  * `quantile` is `jnp.quantile` bit for bit (sort, the same interpolation,
    the weighted sum rounded once as XLA's fused multiply-add rounds it),
    and `contrast_k` is the reference's bit for bit wherever the smoothing
    and gradients are exact (images quantised to a few levels). On a
    rendered panorama the smoothing's rounding differs (XLA contracts the
    filter taps into FMAs), so k is held within 4 f32 steps.
  * One diffusion step on the same image and k^2: within 2.4e-7 (two f32
    steps below 1); the scale space from the same panorama: each level
    within 1e-6 of its largest magnitude; the Hessian response on the
    reference's scale space within 1e-6 of its largest magnitude.
  * `detect_akaze`: slots as tests/test_torch_frontend.py holds Harris's
    (positions equal except near-ties of the max-reduced response within
    1e-5 of its largest magnitude, counted, at most 1 % of K); on equal
    slots, levels and validity equal, subpixel positions within 2.5e-4 px
    (four f32 steps at a column of 768: the parabola's offset comes from
    responses that differ in their last bits).
  * `describe_mldb` on the reference's scale space and keypoints: every
    word equal (the cell means are the reference's sums and scaling).
  * `extract_observations`: slots as for detection; on equal slots validity
    equal, uv within 1e-3 px, rays within 1e-6; descriptor bits computed on
    the port's own scale space may flip where two cell means lie within its
    rounding: at most 1 in 10^3 of the bits (counted).
  * The frame-to-frame replay at tests/test_akaze.py's size (5 frames) with
    the reference's draws: pose_ok equal, positions within 1e-3 m, ATE
    within 1e-3 m of the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.eval.ate import ate_rmse as jax_ate
from sosvo.frontend import akaze as jak
from sosvo.frontend import image_frontend as jif
from sosvo.frontend import panorama as jpano
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.synth.render import RoomScene, render_sequence
from sosvo.synth.scene import make_trajectory as jax_make_trajectory
from sosvo.utils.config import FrontendConfig, PipelineConfig, RansacConfig
from sosvo.vo.image_pipeline import run_replay_images as jax_run_replay_images
from sosvo.vo.state import init_track_state as jax_init_track_state
from sosvo_torch import convert
from sosvo_torch.eval.ate import ate_rmse
from sosvo_torch.frontend import akaze as tak
from sosvo_torch.frontend import image_frontend as tif
from sosvo_torch.frontend.akaze import AkazeKeypoints
from sosvo_torch.kernels import match_cuda
from sosvo_torch.tools.frontend_parity import slot_mismatches, view_keypoints
from sosvo_torch.tools.reference_draws import replay_draws
from sosvo_torch.utils import config as tconfig
from sosvo_torch.vo import image_pipeline as tip

torch.set_num_threads(1)
ROOM = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
FE = FrontendConfig(max_features=384, pano_height=96, pano_width=768, descriptor_patch=16,
                    descriptor="akaze")
RC = RansacConfig(rigid_angle_threshold=0.02, essential_threshold=0.01, min_inliers=8)
F = 5
DETECT = dict(threshold=FE.detect_threshold * 1e-2, nms_radius=FE.nms_grid,
              border_rows=FE.descriptor_patch // 2 + 2)
SLOT_TOL = 1e-5
MAX_SWAPPED = 0.01


def _bits(words):
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=1, bitorder="little")


@pytest.fixture(scope="module")
def world():
    rig = jax_default_rig(image_size=768)
    poses = jax_make_trajectory(F, radius=0.4)
    images = jax.jit(lambda P: render_sequence(rig, P, ROOM))(poses)
    luts = jif.build_frontend_luts(rig, FE)
    panos = [np.asarray(jax.jit(jpano.warp_panorama)(images[f], g))
             for f in (0, 3) for g in (luts.top, luts.bottom)]
    return dict(rig=rig, poses=poses, images=images, luts=luts, panos=panos,
                trig=convert.rig_from_numpy(rig, "cpu"),
                t_images=convert.images_from_numpy(images, "cpu"),
                tluts_ref=convert.frontend_luts_from_numpy(luts, 768, 768, "cpu"))


@pytest.mark.parametrize("n", [1000, 73728, 131072])
def test_quantile_is_jnp_quantile(n):
    rng = np.random.default_rng(n)
    x = (rng.random(n) ** 3).astype(np.float32)
    x[rng.random(n) < 0.1] = 0.0   # ties, as a flat image region gives
    for q in (0.7, 0.25, 1.0):
        ref = np.float32(jax.jit(lambda a: jnp.quantile(a, q))(x))
        got = tak.quantile(torch.tensor(x), q)
        assert got.dtype == torch.float32 and got.shape == ()
        assert np.float32(got) == ref, (q, float(got), float(ref))


@pytest.mark.parametrize("levels", [4, 64])
def test_contrast_k_bit_for_bit(levels):
    img = (np.random.default_rng(levels).integers(0, levels, (96, 768))
           / np.float32(levels)).astype(np.float32)
    ref = np.float32(jax.jit(jak.contrast_k)(img))
    assert np.float32(tak.contrast_k(torch.tensor(img))) == ref


def test_contrast_k_on_a_panorama(world):
    for pano in world["panos"]:
        ref = np.float32(jax.jit(jak.contrast_k)(pano))
        got = np.float32(tak.contrast_k(torch.tensor(pano)))
        steps = abs(int(got.view(np.int32)) - int(ref.view(np.int32)))
        print(f"contrast k {got} reference {ref}: {steps} f32 steps apart")
        assert steps <= 4


def test_diffusion_and_scale_space_match(world):
    pano = world["panos"][0]
    k2 = np.float32(jax.jit(jak.contrast_k)(pano)) ** 2
    ref = np.asarray(jax.jit(lambda x: jak._diffusion_step(x, jnp.float32(k2)))(pano))
    got = tak._diffusion_step(torch.tensor(pano), torch.tensor(k2)).numpy()
    print(f"diffusion step max abs diff {np.abs(got - ref).max():.3e}")
    assert np.abs(got - ref).max() <= 2.4e-7
    ref = np.asarray(jax.jit(jak.nonlinear_scale_space)(pano))
    got = tak.nonlinear_scale_space(torch.tensor(pano)).numpy()
    assert got.shape == ref.shape == (jak.N_LEVELS,) + pano.shape
    for lvl in range(jak.N_LEVELS):
        err = np.abs(got[lvl] - ref[lvl]).max()
        print(f"level {lvl}: max abs diff {err:.3e}")
        assert err <= 1e-6 * np.abs(ref[lvl]).max()


def test_hessian_response_matches(world):
    space = np.asarray(jax.jit(jak.nonlinear_scale_space)(world["panos"][1]))
    ref = np.asarray(jax.jit(jak.hessian_response)(space))
    got = tak.hessian_response(torch.tensor(space)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def _slot_check(rk, gk, resp_scale):
    differ, unexplained = slot_mismatches(rk.rows, rk.cols, rk.response, gk.rows.numpy(),
                                          gk.cols.numpy(), FE.pano_width, SLOT_TOL * resp_scale)
    print(f"slots: {differ.sum()} of {len(differ)} at other positions, "
          f"{unexplained.sum()} unexplained")
    assert not unexplained.any() and differ.mean() <= MAX_SWAPPED
    return ~differ


@pytest.mark.parametrize("i", [0, 3])
def test_detect_akaze_matches(world, i):
    pano = world["panos"][i]
    ref, ref_space = jax.jit(lambda p: jak.detect_akaze(p, FE.max_features, **DETECT))(pano)
    got, _ = tak.detect_akaze(torch.tensor(pano), FE.max_features, **DETECT)
    scale = float(jnp.abs(jnp.max(jak.hessian_response(ref_space), axis=0)).max())
    same = _slot_check(ref.kps, got.kps, scale)
    np.testing.assert_array_equal(got.level.numpy()[same], np.asarray(ref.level)[same])
    np.testing.assert_array_equal(got.kps.valid.numpy()[same], np.asarray(ref.kps.valid)[same])
    for name in ("rows", "cols"):
        err = np.abs(getattr(got.kps, name).numpy() - np.asarray(getattr(ref.kps, name)))[same]
        print(f"{name}: max abs diff {err.max():.3e} px")
        assert err.max() <= 2.5e-4
    assert int(np.asarray(ref.kps.valid).sum()) > 200


@pytest.mark.parametrize("i", [1, 2])
def test_describe_mldb_words_equal(world, i):
    ref_ak, space = jax.jit(lambda p: jak.detect_akaze(p, FE.max_features, **DETECT))(
        world["panos"][i])
    ref = np.asarray(jax.jit(lambda s, a: jak.describe_mldb(s, a, patch=FE.descriptor_patch))(
        space, ref_ak))
    ak = AkazeKeypoints(convert.keypoints_from_numpy(ref_ak.kps, "cpu"),
                        torch.tensor(np.asarray(ref_ak.level)))
    words = tak.describe_mldb(torch.tensor(np.asarray(space)), ak, patch=FE.descriptor_patch)
    assert words.dtype == torch.int32 and words.shape == (FE.max_features, tak.WORDS)
    got = convert.desc_to_numpy(words)
    np.testing.assert_array_equal(got, ref)
    assert (got >= 2**31).any()  # bit 31 set: a negative int32 word with the reference's bits


def test_mldb_pattern_is_the_reference():
    for a, b in zip(tak._mldb_pairs(), jak._mldb_pairs()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("frame", [0, 3])
def test_extract_observations_akaze_matches(world, frame):
    image = np.asarray(world["images"][frame])
    ref = jax.jit(lambda im: jif.extract_observations(world["rig"], world["luts"], FE, im))(image)
    pfe = tconfig._from_dict(tconfig.FrontendConfig, dataclasses.asdict(FE))
    got = tif.extract_observations(world["trig"], world["tluts_ref"], pfe, torch.tensor(image))
    got_kps = view_keypoints(world["tluts_ref"], pfe, torch.tensor(image))
    for view, gk, g in zip(("top", "bottom"), got_kps, (world["luts"].top, world["luts"].bottom)):
        pano = jax.jit(jpano.warp_panorama)(image, g)
        rk, space = jax.jit(lambda p: jak.detect_akaze(p, FE.max_features, **DETECT))(pano)
        same = _slot_check(rk.kps, gk, float(jnp.abs(jnp.max(jak.hessian_response(space),
                                                                axis=0)).max()))
        np.testing.assert_array_equal(getattr(got, f"valid_{view}").numpy()[same],
                                      np.asarray(getattr(ref, f"valid_{view}"))[same])
        np.testing.assert_allclose(getattr(got, f"uv_{view}").numpy()[same],
                                   np.asarray(getattr(ref, f"uv_{view}"))[same], rtol=0, atol=1e-3)
        np.testing.assert_allclose(getattr(got, f"ray_{view}").numpy()[same],
                                   np.asarray(getattr(ref, f"ray_{view}"))[same], rtol=0, atol=1e-6)
        flipped = (_bits(convert.desc_to_numpy(getattr(got, f"desc_{view}")))
                   != _bits(np.asarray(getattr(ref, f"desc_{view}"))))[same]
        print(f"frame {frame} {view}: {flipped.sum()} of {flipped.size} M-LDB bits differ")
        assert flipped.mean() <= 1e-3


def test_akaze_replay_matches(world):
    """tests/test_akaze.py's image-mode frame-to-frame replay, with the
    reference's draws; the M-LDB words go through the Hamming matcher's
    plain twin on CPU tensors (no kernel launch)."""
    cfg = PipelineConfig(frontend=FE, ransac=RC)
    key = jax.random.PRNGKey(2)
    state = jax_init_track_state(FE.max_features, key, T0=world["poses"][0])
    _, ref = jax.jit(lambda s, im: jax_run_replay_images(world["rig"], cfg, s, im,
                                                         luts=world["luts"]))(state, world["images"])
    tcfg = tconfig._from_dict(tconfig.PipelineConfig, dataclasses.asdict(cfg))
    match_cuda.reset_launches()
    _, got = tip.run_replay_images(world["trig"], tcfg,
                                   convert.track_state_from_numpy(state, torch.Generator(), "cpu"),
                                   world["t_images"], luts=world["tluts_ref"],
                                   draws=replay_draws(F, cfg.ransac.n_hyps, FE.max_features, "cpu",
                                                      seed=2))
    assert match_cuda.launches == 0
    np.testing.assert_array_equal(got.pose_ok.numpy(), np.asarray(ref.pose_ok))
    assert np.asarray(ref.pose_ok)[1:].all()
    pos_ref = np.asarray(ref.T_world)[:, :3, 3]
    assert np.abs(got.T_world.numpy()[:, :3, 3] - pos_ref).max() < 1e-3
    gt = np.asarray(world["poses"])[1:, :3, 3]
    ate_ref = float(jax_ate(jnp.asarray(pos_ref[1:]), jnp.asarray(gt))[0])
    ate_got = float(ate_rmse(got.T_world[1:, :3, 3], torch.tensor(gt))[0])
    print(f"AKAZE f2f ATE port {ate_got} reference {ate_ref}")
    assert abs(ate_got - ate_ref) < 1e-3
