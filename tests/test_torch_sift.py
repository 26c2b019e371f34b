"""The SIFT descriptor option: the port's L2 matcher (`frontend/match.py`),
`describe_sift`, SIFT extraction and the SIFT replays against the JAX
package's.

Inputs: random unit descriptors from numpy seeds, and the CLI's room
rendered by the JAX package through `default_rig(768)` with
tests/test_sift.py's frontend (a 96x768 panorama, 16 px patches).

Tolerances, and what sets them:
  * `l2_matrix`: within 2e-5 of the reference's Gram form (unit-norm 128-d
    descriptors; the f32 Gram product's summation order differs).
  * `match_l2` on 40 planted matches among random descriptors, with and
    without the stereo band: indices, validity and the cross-check equal;
    distances within 2e-5. Rows whose best and second best lie within
    rounding (2e-5) may order either way: counted, none expected.
  * `describe_sift` on the reference's smoothed panorama and keypoints:
    XLA's CPU `atan2` and torch's differ in the last bit on ~16 % of
    samples, and the reference contracts multiply-adds into FMAs, so a
    sample within an f32 step of an orientation-bin edge can change bins.
    Held: every descriptor within 1e-6 except at most 1 % of them
    (counted), and none more than 0.05 from the reference in L2.
  * `extract_observations`: slots as tests/test_torch_frontend.py holds
    BRIEF's (near-ties may swap); on equal slots, validity equal, uv within
    1e-3 px, rays within 1e-6, descriptors as for `describe_sift`.
  * The BA replay at tests/test_sift.py's size (K=192, 12 frames, a
    keyframe every 3) with the reference's draws, then its loop leg:
    pose_ok and is_keyframe equal, positions within 1e-3 m, ATE within
    1e-3 m of the reference's, before and after the leg.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.eval.ate import ate_rmse as jax_ate
from sosvo.frontend import descriptor as jdesc
from sosvo.frontend import detect as jdet
from sosvo.frontend import image_frontend as jif
from sosvo.frontend import match as jmatch
from sosvo.frontend import panorama as jpano
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.synth.render import RoomScene, render_sequence
from sosvo.synth.scene import make_trajectory as jax_make_trajectory
from sosvo.utils.config import FrontendConfig, PipelineConfig, RansacConfig
from sosvo.vo import ba_pipeline as jbp
from sosvo.vo.loop_closure import pgo_refine_trajectory as jax_pgo
from sosvo_torch import convert
from sosvo_torch.eval.ate import ate_rmse
from sosvo_torch.frontend import descriptor as tdesc
from sosvo_torch.frontend import image_frontend as tif
from sosvo_torch.frontend import match as tmatch
from sosvo_torch.kernels import match_cuda
from sosvo_torch.tools.frontend_parity import slot_mismatches, view_keypoints
from sosvo_torch.tools.reference_draws import loop_draws, replay_draws
from sosvo_torch.utils import config as tconfig
from sosvo_torch.vo.ba_pipeline import run_replay_ba
from sosvo_torch.vo.loop_closure import pgo_refine_trajectory

torch.set_num_threads(1)
ROOM = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
FE = FrontendConfig(max_features=192, pano_height=96, pano_width=768, descriptor_patch=16,
                    descriptor="sift")
RC = RansacConfig(rigid_angle_threshold=0.02, essential_threshold=0.01, min_inliers=8)
L2_TOL = 2e-5
DESC_TOL = 1e-6
MAX_BIN_MOVES = 0.01
BIN_MOVE_L2 = 0.05
REL_TOL = 1e-6


def _port(cfg, cls):
    return tconfig._from_dict(cls, dataclasses.asdict(cfg))


def _unit(rng, n):
    x = rng.random((n, tdesc.SIFT_DIM)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _planted(seed, ka=150, kb=220, planted=40):
    """Random unit descriptors with `planted` rows of A copied into B with
    noise, A row 3i -> B row 5i; azimuths with the planted pairs 0.01 rad
    apart; a tenth of each side invalid."""
    rng = np.random.default_rng(seed)
    a, b = _unit(rng, ka), _unit(rng, kb)
    ia, ib = 3 * np.arange(planted), 5 * np.arange(planted)
    noisy = a[ia] + 0.02 * rng.standard_normal((planted, tdesc.SIFT_DIM)).astype(np.float32)
    b[ib] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
    az_a = rng.uniform(-np.pi, np.pi, ka).astype(np.float32)
    az_b = rng.uniform(-np.pi, np.pi, kb).astype(np.float32)
    az_b[ib] = np.angle(np.exp(1j * (az_a[ia] + 0.01))).astype(np.float32)
    va, vb = rng.random(ka) > 0.1, rng.random(kb) > 0.1
    va[ia], vb[ib] = True, True
    return a, b, va, vb, az_a, az_b


def test_l2_matrix_matches():
    rng = np.random.default_rng(1)
    a, b = _unit(rng, 57), _unit(rng, 71)
    ref = np.asarray(jmatch.l2_matrix_mxu(jnp.asarray(a), jnp.asarray(b)))
    got = tmatch.l2_matrix(torch.tensor(a), torch.tensor(b)).numpy()
    print(f"l2_matrix max abs diff {np.abs(got - ref).max():.3e}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=L2_TOL)
    same = tmatch.l2_matrix(torch.tensor(a), torch.tensor(a)).numpy()
    assert np.all(np.isfinite(same)) and np.abs(np.diag(same)).max() < 1e-3


def test_metric_params_is_the_reference():
    for d in ("brief", "sift", "akaze"):
        fe = dataclasses.replace(FE, descriptor=d)
        assert tmatch.metric_params(_port(fe, tconfig.FrontendConfig)) == jmatch.metric_params(fe)


@pytest.mark.parametrize("band", [0.0, 0.06])
def test_match_l2_matches(band):
    a, b, va, vb, az_a, az_b = _planted(3)
    penalty = (jmatch.column_band_penalty(jnp.asarray(az_a), jnp.asarray(az_b), band,
                                          wrap=2.0 * np.pi) if band > 0 else None)
    ref = jax.jit(lambda a, b, va, vb: jmatch.match(a, b, va, vb, max_distance=0.7, ratio=0.9,
                                                    penalty=penalty, metric="l2"))(a, b, va, vb)
    got = tmatch.match_l2(torch.tensor(a), torch.tensor(b), torch.tensor(va), torch.tensor(vb),
                          max_distance=0.7, ratio=0.9, az_a=torch.tensor(az_a),
                          az_b=torch.tensor(az_b), band=band)
    d = tmatch.l2_matrix(torch.tensor(a), torch.tensor(b)).numpy()
    d[~va] = np.inf
    d[:, ~vb] = np.inf
    top2 = np.sort(d, axis=1)[:, :2]
    with np.errstate(invalid="ignore"):  # rows of inf: no tie to count
        near = (top2[:, 1] - top2[:, 0]) <= L2_TOL
    print(f"band={band}: {near.sum()} rows with a near-tie for the best match, "
          f"{int(np.asarray(ref.valid).sum())} valid")
    assert not near[va].any()
    np.testing.assert_array_equal(got.idx_b.numpy(), np.asarray(ref.idx_b))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    fin = np.asarray(ref.dist) < 1e8
    np.testing.assert_allclose(got.dist.numpy()[fin], np.asarray(ref.dist)[fin], rtol=0,
                               atol=L2_TOL)
    # the planted pairs are found
    assert int(np.asarray(ref.valid)[3 * np.arange(40)].sum()) >= 38
    # and the dispatcher takes the same route
    via = match_cuda.match_metric("l2", torch.tensor(a), torch.tensor(b), torch.tensor(va),
                                  torch.tensor(vb), 0.7, 0.9, torch.tensor(az_a),
                                  torch.tensor(az_b), band)
    assert all(torch.equal(x, y) for x, y in zip(via, got))


def test_match_l2_refuses_words():
    w = torch.zeros((4, 8), dtype=torch.int32)
    v = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="float"):
        tmatch.match_l2(w, w, v, v)


@pytest.fixture(scope="module")
def world():
    rig = jax_default_rig(image_size=768)
    poses = jax_make_trajectory(12, radius=0.4)
    images = jax.jit(lambda P: render_sequence(rig, P, ROOM))(poses)
    luts = jif.build_frontend_luts(rig, FE)
    trig = convert.rig_from_numpy(rig, "cpu")
    return dict(rig=rig, poses=poses, images=images, luts=luts, trig=trig,
                t_images=convert.images_from_numpy(images, "cpu"),
                tluts_ref=convert.frontend_luts_from_numpy(luts, 768, 768, "cpu"))


def _desc_check(label, got, ref):
    err = np.abs(got - ref).max(axis=1)
    moved = err > DESC_TOL
    l2 = np.linalg.norm(got - ref, axis=1)
    print(f"{label}: max abs diff {err.max():.3e}, {moved.sum()} of {len(err)} descriptors "
          f"beyond {DESC_TOL} (a sample across a bin edge), largest L2 gap {l2.max():.3e}")
    assert moved.mean() <= MAX_BIN_MOVES and l2.max() < BIN_MOVE_L2
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("oriented", [False, True])
def test_describe_sift_matches(world, oriented):
    geom = world["luts"].top
    pano = jax.jit(jpano.warp_panorama)(world["images"][4], geom)
    kps = jax.jit(lambda p: jdet.detect(p, FE.max_features, threshold=4e-7, nms_radius=3,
                                        border_rows=10))(pano)
    smoothed = jax.jit(jdet.gaussian_smooth)(pano)
    angles = jax.jit(jdesc.orientation)(smoothed, kps) if oriented else None
    ref = np.asarray(jax.jit(jdesc.describe_sift)(pano, kps, smoothed, angles))
    got = tdesc.describe_sift(torch.tensor(np.asarray(pano)), convert.keypoints_from_numpy(kps, "cpu"),
                              smoothed=torch.tensor(np.asarray(smoothed)),
                              angles=None if angles is None else torch.tensor(np.asarray(angles)))
    assert got.shape == (FE.max_features, tdesc.SIFT_DIM) and got.dtype == torch.float32
    _desc_check(f"describe_sift oriented={oriented}", got.numpy(), ref)


def test_sift_constants_are_the_reference():
    np.testing.assert_array_equal(tdesc._SIFT_GRID, jdesc._SIFT_GRID)
    np.testing.assert_array_equal(tdesc._SIFT_W, jdesc._SIFT_W)
    assert (tdesc.SIFT_DIM, tdesc._SIFT_CLIP) == (jdesc.SIFT_DIM, jdesc._SIFT_CLIP)


@pytest.mark.parametrize("frame", [0, 7])
def test_extract_observations_sift_matches(world, frame):
    image = np.asarray(world["images"][frame])
    ref = jax.jit(lambda im: jif.extract_observations(world["rig"], world["luts"], FE, im))(image)
    pfe = _port(FE, tconfig.FrontendConfig)
    got = tif.extract_observations(world["trig"], world["tluts_ref"], pfe, torch.tensor(image))
    got_kps = view_keypoints(world["tluts_ref"], pfe, torch.tensor(image))
    for view, gk, g in zip(("top", "bottom"), got_kps, (world["luts"].top, world["luts"].bottom)):
        pano = jax.jit(jpano.warp_panorama)(image, g)
        rk = jax.jit(lambda p: jdet.detect(p, FE.max_features, threshold=FE.detect_threshold * 1e-7,
                                           nms_radius=FE.nms_grid,
                                           border_rows=FE.descriptor_patch // 2 + 2))(pano)
        scale = float(jnp.abs(jdet.harris_response(jdet.gaussian_smooth(pano))).max())
        differ, unexplained = slot_mismatches(rk.rows, rk.cols, rk.response, gk.rows.numpy(),
                                              gk.cols.numpy(), FE.pano_width, REL_TOL * scale)
        print(f"frame {frame} {view}: {differ.sum()} slots elsewhere, {unexplained.sum()} unexplained")
        assert not unexplained.any() and differ.mean() <= 0.01
        same = ~differ
        np.testing.assert_array_equal(getattr(got, f"valid_{view}").numpy()[same],
                                      np.asarray(getattr(ref, f"valid_{view}"))[same])
        np.testing.assert_allclose(getattr(got, f"uv_{view}").numpy()[same],
                                   np.asarray(getattr(ref, f"uv_{view}"))[same], rtol=0, atol=1e-3)
        np.testing.assert_allclose(getattr(got, f"ray_{view}").numpy()[same],
                                   np.asarray(getattr(ref, f"ray_{view}"))[same], rtol=0, atol=1e-6)
        desc = getattr(got, f"desc_{view}")
        assert desc.dtype == torch.float32 and desc.shape == (FE.max_features, tdesc.SIFT_DIM)
        _desc_check(f"frame {frame} {view}", convert.desc_to_numpy(desc)[same],
                    np.asarray(getattr(ref, f"desc_{view}"))[same])


def test_sift_ba_replay_and_leg_match(world):
    """tests/test_sift.py's composition: SIFT extraction, the window-BA
    replay (map association and relocalisation by L2), then loop closure
    and PGO over it (float signatures, L2 pair matches)."""
    cfg = PipelineConfig(frontend=FE, ransac=RC, keyframe_every=3)
    key = jax.random.PRNGKey(2)
    state = jbp.init_ba_state(cfg, key, T0=world["poses"][0])
    obs = jax.jit(jax.vmap(lambda im: jif.extract_observations(world["rig"], world["luts"], FE,
                                                               im)))(world["images"])
    _, ref = jax.jit(lambda s, o: jbp.run_replay_ba(world["rig"], cfg, s, o))(state, obs)
    T_ref, n_ref = jax.jit(lambda o, T: jax_pgo(world["rig"], cfg, o, T, min_gap=3, min_inliers=15,
                                                max_candidates=6))(obs, ref.vo.T_world)

    tcfg = _port(cfg, tconfig.PipelineConfig)
    tobs = tif.extract_sequence(world["trig"], world["tluts_ref"], tcfg.frontend, world["t_images"])
    assert tobs.desc_top.dtype == torch.float32
    n, h, k, l = 12, cfg.ransac.n_hyps, FE.max_features, cfg.ba.max_landmarks
    tstate = convert.ba_state_from_numpy(state, torch.Generator(), "cpu")
    assert tstate.map.lm_desc.dtype == torch.float32 and tstate.map.lm_desc.shape == (l, 128)
    match_cuda.reset_launches()
    final, got = run_replay_ba(world["trig"], tcfg, tstate, tobs,
                               replay_draws(n, h, k, "cpu", seed=2, reloc_slots=l))
    T_got, n_got = pgo_refine_trajectory(world["trig"], tcfg, tobs, got.vo.T_world, min_gap=3,
                                         min_inliers=15, max_candidates=6,
                                         gumbels=loop_draws(6, h, k, "cpu"))
    assert match_cuda.launches == 0
    assert final.map.lm_desc.dtype == torch.float32 and bool(final.map.lm_valid.any())

    np.testing.assert_array_equal(got.is_keyframe.numpy(), np.asarray(ref.is_keyframe))
    np.testing.assert_array_equal(got.vo.pose_ok.numpy(), np.asarray(ref.vo.pose_ok))
    assert np.asarray(ref.vo.pose_ok)[1:].all() and np.asarray(ref.is_keyframe).sum() >= 3
    gt = np.asarray(world["poses"])[1:, :3, 3]
    assert int(n_got) == int(n_ref)
    for name, g, r in (("BA replay", got.vo.T_world, ref.vo.T_world), ("after the leg", T_got, T_ref)):
        pos_ref = np.asarray(r)[:, :3, 3]
        assert np.abs(g.numpy()[:, :3, 3] - pos_ref).max() < 1e-3, name
        ate_ref = float(jax_ate(jnp.asarray(pos_ref[1:]), jnp.asarray(gt))[0])
        ate_got = float(ate_rmse(g[1:, :3, 3], torch.tensor(gt))[0])
        print(f"{name}: ATE port {ate_got} reference {ate_ref}")
        assert abs(ate_got - ate_ref) < 1e-3
