"""The image frontend: `sosvo_torch.frontend` (panorama, detect, descriptor,
image_frontend) against the JAX package's `sosvo.frontend`.

Inputs: frames 0 and 3 of the CLI's room rendered by the JAX package along
`make_trajectory(6, radius=0.4)` through `default_rig(768)`, with the JAX
image tests' frontend (K=384, a 96x768 panorama, 16 px patches), handed to
the port as numpy arrays.

Tolerances, and what sets them:
  * LUT: `lut_uv` within 2e-4 px and `valid` equal. The raw-image
    coordinates reach 768 px, where one f32 step is 6.1e-5 px; the
    reference's XLA CPU code evaluates sin/cos with its own polynomials and
    contracts multiply-adds into FMAs, which leaves it up to 2 steps
    (1.22e-4 px) from the port. The bilinear cells agree except where a
    coordinate lies within 2e-4 of an integer.
  * Warp on the reference's own LUT: bit-equal to the reference's lerp
    evaluated in f32 one operation at a time (numpy), and within 2.4e-7
    (two f32 steps below 1) of the JAX warp, which XLA contracts into FMAs.
  * Detection on the same panorama: the smoothed image and the response
    map within 1e-6 of their largest magnitude; the slots (top-K order,
    -inf tail included) at the same positions except slots whose response
    lies within 1e-6 of the map's largest magnitude of a neighbouring
    slot's or of the K-th value (`tools/frontend_parity.py`: a near-tie two f32 roundings
    may order either way), counted and at most 1 % of K; on equal slots,
    subpixel rows and cols within 1e-4 px and validity equal. A panorama with
    fewer maxima than K exercises the -inf tie order: every slot equal.
  * BRIEF on the same keypoints and panorama: bit-equal except bits whose
    two samples differ by under 1e-6 (counted; the Hamming distance is at
    most that count).
  * `extract_observations` on the same image: slots as for detection; on
    equal slots validity equal, `uv` within 1e-3 px, rays within 1e-6,
    `lm_id` all -1; descriptors, on the reference's LUTs, as for BRIEF, and
    with each package's own LUTs at most 1e-4 of the bits and 2 bits of
    any descriptor apart (the LUTs' f32 steps move the panorama by up to
    ~3e-5 at the checker's edges).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.frontend import descriptor as jdesc
from sosvo.frontend import detect as jdet
from sosvo.frontend import image_frontend as jif
from sosvo.frontend import panorama as jpano
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.synth.render import RoomScene, render_sequence
from sosvo.synth.scene import make_trajectory as jax_make_trajectory
from sosvo.utils.config import FrontendConfig
from sosvo_torch import convert
from sosvo_torch.frontend import descriptor as tdesc
from sosvo_torch.frontend import detect as tdet
from sosvo_torch.frontend import image_frontend as tif
from sosvo_torch.frontend import panorama as tpano
from sosvo_torch.tools.frontend_parity import slot_mismatches, view_keypoints
from sosvo_torch.utils import config as tconfig

torch.set_num_threads(1)
ROOM = RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
FE = FrontendConfig(max_features=384, pano_height=96, pano_width=768, descriptor_patch=16)
SIZE = 768
LUT_TOL = 2e-4
WARP_TOL = 2.4e-7
REL_TOL = 1e-6
MAX_SWAPPED = 0.01


def _port_fe(fe):
    return tconfig._from_dict(tconfig.FrontendConfig, dataclasses.asdict(fe))


@pytest.fixture(scope="module")
def world():
    rig = jax_default_rig(image_size=SIZE)
    poses = jax_make_trajectory(6, radius=0.4)
    images = np.asarray(jax.jit(lambda P: render_sequence(rig, P, ROOM))(poses[jnp.array([0, 3])]))
    luts = jif.build_frontend_luts(rig, FE)
    trig = convert.rig_from_numpy(rig, "cpu")
    return dict(rig=rig, trig=trig, images=images, luts=luts,
                tluts=tif.build_frontend_luts(trig, _port_fe(FE)),
                tluts_ref=convert.frontend_luts_from_numpy(luts, SIZE, SIZE, "cpu"))


def _panos(world, view="top", frame=0):
    """(the JAX warp on its LUT, the same panorama as a tensor)."""
    pano = np.asarray(jax.jit(jpano.warp_panorama)(jnp.asarray(world["images"][frame]),
                                                    getattr(world["luts"], view)))
    return pano, torch.tensor(pano)


@pytest.mark.parametrize("view", ["top", "bottom"])
def test_pano_lut_matches(world, view):
    ref, got, dec = (getattr(world[k], view) for k in ("luts", "tluts", "tluts_ref"))
    uv = np.asarray(ref.lut_uv)
    err = np.abs(got.lut_uv.numpy() - uv).max()
    print(f"{view}: lut_uv max abs diff {err:.3e} px")
    assert err < LUT_TOL
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert (got.height, got.width) == (FE.pano_height, FE.pano_width)
    assert (got.min_elevation, got.max_elevation) == (ref.min_elevation, ref.max_elevation)
    for i, name in enumerate(("u0", "v0")):
        c = np.clip(uv[..., i], 0.0, SIZE - 1.001)
        near_int = np.abs(c - np.round(c)) < LUT_TOL
        differ = getattr(got, name).numpy() != getattr(dec, name).numpy()
        assert not (differ & ~near_int).any(), name
    for name in ("fu", "fv"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=LUT_TOL, err_msg=name)


@pytest.mark.parametrize("view", ["top", "bottom"])
def test_warp_on_the_reference_lut(world, view):
    geom, ref_geom = getattr(world["tluts_ref"], view), getattr(world["luts"], view)
    image = world["images"][1]
    got = tpano.warp_panorama(torch.tensor(image), geom).numpy()
    # The reference's lerps, one f32 operation at a time.
    u0, v0 = geom.u0.numpy(), geom.v0.numpy()
    fu, fv = np.asarray(ref_geom.fu), np.asarray(ref_geom.fv)
    one = np.float32(1.0)
    q = [image[v0 + dv, u0 + du] for dv, du in ((0, 0), (0, 1), (1, 0), (1, 1))]
    a = q[0] * (one - fu) + q[1] * fu
    b = q[2] * (one - fu) + q[3] * fu
    plain = np.where(np.asarray(ref_geom.valid), a * (one - fv) + b * fv, np.float32(0.0))
    np.testing.assert_array_equal(got, plain)
    ref = np.asarray(jax.jit(jpano.warp_panorama)(jnp.asarray(image), ref_geom))
    print(f"{view}: warp vs JAX max abs diff {np.abs(got - ref).max():.3e}, "
          f"bit-equal share {(got == ref).mean():.4f}")
    assert np.abs(got - ref).max() <= WARP_TOL


def test_pano_coordinates_match():
    rows = np.linspace(-0.5, 95.5, 37, dtype=np.float32)
    cols = np.linspace(-0.5, 767.5, 37, dtype=np.float32)
    args = (96, 768, -0.6, 0.2)
    np.testing.assert_allclose(tpano.pano_ray(*args, torch.tensor(rows), torch.tensor(cols)).numpy(),
                               np.asarray(jpano.pano_ray(*args, jnp.asarray(rows), jnp.asarray(cols))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tpano.pano_azimuth(768, torch.tensor(cols)).numpy(),
                               np.asarray(jpano.pano_azimuth(768, jnp.asarray(cols))), atol=1e-6)
    np.testing.assert_allclose(tpano.pano_elevation(96, -0.6, 0.2, torch.tensor(rows)).numpy(),
                               np.asarray(jpano.pano_elevation(96, -0.6, 0.2, jnp.asarray(rows))),
                               atol=1e-6)


@pytest.mark.parametrize("view", ["top", "bottom"])
def test_filters_match(world, view):
    pano, tp = _panos(world, view)
    for name, jf, tf in (("smooth", jdet.gaussian_smooth, tdet.gaussian_smooth),
                         ("harris", lambda p: jdet.harris_response(jdet.gaussian_smooth(p)),
                          lambda p: tdet.harris_response(tdet.gaussian_smooth(p)))):
        ref = np.asarray(jax.jit(jf)(jnp.asarray(pano)))
        got = tf(tp).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * np.abs(ref).max(), err_msg=name)
    # On the same input map, NMS and the FAST mask are exact.
    resp = tdet.harris_response(tdet.gaussian_smooth(tp))
    for r in (1, 3):
        np.testing.assert_array_equal(
            tdet.nms_local_max(resp, r).numpy(),
            np.asarray(jax.jit(lambda x: jdet.nms_local_max(x, r))(jnp.asarray(resp.numpy()))))
    smoothed = tdet.gaussian_smooth(tp)
    np.testing.assert_array_equal(tdet.fast_mask(smoothed).numpy(),
                                  np.asarray(jax.jit(jdet.fast_mask)(jnp.asarray(smoothed.numpy()))))


def _map_scale(pano):
    """The largest magnitude of the reference's Harris response map."""
    return float(np.abs(np.asarray(jax.jit(
        lambda p: jdet.harris_response(jdet.gaussian_smooth(p)))(jnp.asarray(pano)))).max())


def _slot_check(ref_kps, got_kps, width, scale):
    differ, unexplained = slot_mismatches(ref_kps.rows, ref_kps.cols, ref_kps.response,
                                          got_kps.rows.numpy(), got_kps.cols.numpy(), width,
                                          REL_TOL * scale)
    k = len(differ)
    print(f"slots: {differ.sum()} of {k} at other positions, {unexplained.sum()} unexplained")
    assert not unexplained.any() and differ.mean() <= MAX_SWAPPED
    return ~differ


@pytest.mark.parametrize("detector", ["harris", "fast"])
@pytest.mark.parametrize("view", ["top", "bottom"])
def test_detect_matches(world, view, detector):
    pano, tp = _panos(world, view)
    kw = dict(threshold=FE.detect_threshold * 1e-7, nms_radius=FE.nms_grid,
              border_rows=FE.descriptor_patch // 2 + 2, detector=detector)
    ref = jax.jit(lambda p: jdet.detect(p, FE.max_features, **kw))(jnp.asarray(pano))
    got = tdet.detect(tp, FE.max_features, **kw)
    scale = _map_scale(pano)
    same = _slot_check(ref, got, FE.pano_width, scale)
    np.testing.assert_array_equal(got.valid.numpy()[same], np.asarray(ref.valid)[same])
    for name in ("rows", "cols"):
        np.testing.assert_allclose(getattr(got, name).numpy()[same],
                                   np.asarray(getattr(ref, name))[same], rtol=0, atol=1e-4)
    r = np.asarray(ref.response)
    fin = np.isfinite(r)
    np.testing.assert_array_equal(np.isfinite(got.response.numpy()), fin)
    np.testing.assert_allclose(got.response.numpy()[fin & same], r[fin & same], rtol=0,
                               atol=REL_TOL * scale)
    assert int(np.asarray(ref.valid).sum()) > 100


def test_detect_with_fewer_maxima_than_k():
    """A narrow band of random texture: NMS leaves fewer maxima than K, and
    the rest of the K slots are -inf ties, filled by lowest flat index in
    both packages (and by lax.top_k)."""
    h, w, k = 32, 64, 128
    pano = np.random.default_rng(11).random((h, w)).astype(np.float32)
    kw = dict(threshold=4e-7, nms_radius=3, border_rows=13)
    got = tdet.detect(torch.tensor(pano), k, **kw)
    for exact in (False, True):
        ref = jax.jit(lambda p: jdet.detect(p, k, exact_topk=exact, **kw))(jnp.asarray(pano))
        r = np.asarray(ref.response)
        assert 0 < np.isfinite(r).sum() < k // 2          # the tail is -inf ties
        for name in ("rows", "cols"):
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                       rtol=0, atol=1e-4, err_msg=name)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(np.isfinite(got.response.numpy()), np.isfinite(r))


def test_top_k_order_is_lax_top_k():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 6, size=4096).astype(np.float32)
    x[rng.random(4096) < 0.5] = -np.inf
    for k in (1, 100, 2048, 4096):
        vals, idx = tdet.top_k_ordered(torch.tensor(x), k)
        ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


def _near_equal_pairs(smoothed, kps, angles=None):
    """(K, 256) bool: the BRIEF bits whose two samples differ by under
    REL_TOL on the reference's smoothed panorama."""
    h, w = smoothed.shape
    rows, cols = np.asarray(kps.rows)[:, None], np.asarray(kps.cols)[:, None]

    def sample(pat):
        dr, dc = pat[None, :, 0], pat[None, :, 1]
        if angles is not None:
            ca, sa = np.cos(angles)[:, None], np.sin(angles)[:, None]
            dr, dc = sa * dc + ca * dr, ca * dc - sa * dr
        r = np.clip(np.round(rows + dr).astype(int), 0, h - 1)
        return smoothed[r, np.mod(np.round(cols + dc).astype(int), w)]

    return np.abs(sample(jdesc._PAT_A) - sample(jdesc._PAT_B)) < REL_TOL


def _bits(words):
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=1, bitorder="little")


@pytest.mark.parametrize("oriented", [False, True])
@pytest.mark.parametrize("view", ["top", "bottom"])
def test_describe_matches(world, view, oriented):
    pano, tp = _panos(world, view, frame=1)
    kw = dict(threshold=4e-7, nms_radius=3, border_rows=10)
    kps = jax.jit(lambda p: jdet.detect(p, FE.max_features, **kw))(jnp.asarray(pano))
    smoothed = np.asarray(jax.jit(jdet.gaussian_smooth)(jnp.asarray(pano)))
    tkps = convert.keypoints_from_numpy(kps, "cpu")
    angles = None
    if oriented:
        angles = np.asarray(jax.jit(jdesc.orientation)(jnp.asarray(smoothed), kps))
        got_angles = tdesc.orientation(torch.tensor(smoothed), tkps).numpy()
        np.testing.assert_allclose(got_angles, angles, rtol=0, atol=1e-5)
    ref = np.asarray(jax.jit(jdesc.describe)(jnp.asarray(pano), kps, None,
                                             None if angles is None else jnp.asarray(angles)))
    got = convert.desc_to_numpy(tdesc.describe(
        tp, tkps, angles=None if angles is None else torch.tensor(angles)))
    assert got.shape == (FE.max_features, tdesc.WORDS) and got.dtype == np.uint32
    flipped = _bits(got) != _bits(ref)
    allowed = _near_equal_pairs(smoothed, kps, angles)
    print(f"{view} oriented={oriented}: {flipped.sum()} bits differ, {allowed.sum()} near-equal")
    assert not (flipped & ~allowed).any()
    assert flipped.sum(axis=1).max() <= allowed.sum(axis=1).max()


def test_pattern_is_the_reference_pattern():
    np.testing.assert_array_equal(tdesc._PAT_A, jdesc._PAT_A)
    np.testing.assert_array_equal(tdesc._PAT_B, jdesc._PAT_B)
    for a, b in zip(tdesc._disk_offsets(), jdesc._disk_offsets()):
        np.testing.assert_array_equal(a, b)


def _ref_view_keypoints(world, image):
    return [jax.jit(lambda im, g: jdet.detect(jpano.warp_panorama(im, g), FE.max_features,
                                              threshold=FE.detect_threshold * 1e-7,
                                              nms_radius=FE.nms_grid,
                                              border_rows=FE.descriptor_patch // 2 + 2))(
                jnp.asarray(image), g) for g in (world["luts"].top, world["luts"].bottom)]


def _compare_observations(world, image, luts, fe=FE):
    """Slot check per view; returns per view (equal-slot mask, reference
    observations, port observations, reference keypoints, panorama)."""
    ref = jax.jit(lambda im: jif.extract_observations(world["rig"], world["luts"], fe, im))(
        jnp.asarray(image))
    got = tif.extract_observations(world["trig"], luts, _port_fe(fe), torch.tensor(image))
    np.testing.assert_array_equal(got.lm_id.numpy(), np.full(fe.max_features, -1))
    out = {}
    got_kps = view_keypoints(luts, _port_fe(fe), torch.tensor(image))
    for view, rk, gk, g in zip(("top", "bottom"), _ref_view_keypoints(world, image), got_kps,
                               (world["luts"].top, world["luts"].bottom)):
        pano = np.asarray(jax.jit(jpano.warp_panorama)(jnp.asarray(image), g))
        same = _slot_check(rk, gk, fe.pano_width, _map_scale(pano))
        np.testing.assert_array_equal(getattr(got, f"valid_{view}").numpy()[same],
                                      np.asarray(getattr(ref, f"valid_{view}"))[same])
        np.testing.assert_allclose(getattr(got, f"uv_{view}").numpy()[same],
                                   np.asarray(getattr(ref, f"uv_{view}"))[same], rtol=0, atol=1e-3)
        np.testing.assert_allclose(getattr(got, f"ray_{view}").numpy()[same],
                                   np.asarray(getattr(ref, f"ray_{view}"))[same], rtol=0, atol=1e-6)
        assert int(np.asarray(getattr(ref, f"valid_{view}")).sum()) > 200
        flipped = (_bits(convert.desc_to_numpy(getattr(got, f"desc_{view}")))
                   != _bits(np.asarray(getattr(ref, f"desc_{view}"))))[same]
        out[view] = (flipped, rk, pano, same)
    return out


@pytest.mark.parametrize("frame", [0, 1])
def test_extract_observations_matches(world, frame):
    """On the reference's LUTs: descriptors of equal slots bit-equal except
    near-equal sample pairs, as for `describe`."""
    image = world["images"][frame]
    for view, (flipped, rk, pano, same) in _compare_observations(world, image,
                                                                 world["tluts_ref"]).items():
        smoothed = np.asarray(jax.jit(jdet.gaussian_smooth)(jnp.asarray(pano)))
        allowed = _near_equal_pairs(smoothed, rk)[same]
        print(f"frame {frame} {view}: {flipped.sum()} descriptor bits differ, "
              f"{allowed.sum()} near-equal")
        assert not (flipped & ~allowed).any()


@pytest.mark.parametrize("frame", [0, 1])
def test_extract_observations_with_own_luts(world, frame):
    """Each package with its own LUTs: the panoramas then differ by the
    LUTs' f32 steps (up to ~3e-5 in value at the checker's edges), which
    can flip a BRIEF bit whose samples are that close: at most 1 in 10^4
    of the equal slots' bits, and 2 in any one descriptor."""
    for view, (flipped, *_rest) in _compare_observations(world, world["images"][frame],
                                                        world["tluts"]).items():
        print(f"frame {frame} {view}: {flipped.sum()} of {flipped.size} descriptor bits differ")
        assert flipped.mean() <= 1e-4 and flipped.sum(axis=1).max() <= 2


def test_pyramid_and_steering_match(world):
    """n_scales=2 with steered BRIEF: the slots of both octaves, in order."""
    fe = dataclasses.replace(FE, n_scales=2, oriented=True)
    image = world["images"][0]
    ref = jax.jit(lambda im: jif.extract_observations(world["rig"], world["luts"], fe, im))(
        jnp.asarray(image))
    got = tif.extract_observations(world["trig"], world["tluts"], _port_fe(fe), torch.tensor(image))
    for view in ("top", "bottom"):
        ray_ok = np.abs(getattr(got, f"ray_{view}").numpy()
                        - np.asarray(getattr(ref, f"ray_{view}"))).max(axis=1) < 1e-5
        print(f"n_scales=2 {view}: {(~ray_ok).sum()} of {fe.max_features} slots elsewhere")
        assert ray_ok.mean() >= 1 - 2 * MAX_SWAPPED
        np.testing.assert_array_equal(getattr(got, f"valid_{view}").numpy()[ray_ok],
                                      np.asarray(getattr(ref, f"valid_{view}"))[ray_ok])
        same_desc = (convert.desc_to_numpy(getattr(got, f"desc_{view}"))
                     == np.asarray(getattr(ref, f"desc_{view}"))).all(axis=1)
        assert same_desc[ray_ok].mean() >= 0.99
