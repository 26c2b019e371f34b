"""Calibration from pixels: the board renderer (`sosvo_torch.synth.board`)
and the corner chain (`sosvo_torch.calib.corners`) against the JAX
package's, on the CPU.

Five chessboard captures (5 x 4 inner corners, 7 cm squares, 0.45 m from
the rig around it, alternately tilted) are rendered at 1024 px through a
rig perturbed in fx, cx, fy, cy and the baseline (tests/test_calib_corners.py
renders at 1536; the chain keeps 3 of these 5 boards at 1024 px, in both
packages). The render must equal the reference's but where a supersample
falls within rounding of a checker edge (RENDER_EDGE_SHARE of the pixels at
most, each at most one supersample's 0.25 off). The detector and the
lattice growing are numpy in both packages: on equal images, saddles,
strengths and grown grids must be equal. A planar grid fits its own
image under each of the board's four dihedral flips applied to both views
alike (each is a proper rotation of the plane: rot180 in-plane, or a
flip-over), so the symmetry resolution has four hypotheses of equal
residual, and f32 rounding picks among them; the port's pick must equal
the reference's up to such a common flip, with residuals within SYM_RTOL,
and the observation bundle likewise, board by board (the fitted board pose
absorbs the flip). The pixels-to-parameters loop is held to ground truth
with the reference test's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.calib import corners as jc
from sosvo.calib.boards import make_board_grid as jax_make_board_grid
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.synth import board as jboard
from sosvo_torch.calib import corners as tc
from sosvo_torch.calib.boards import fit_rig_from_boards, make_board_grid
from sosvo_torch.convert import rig_from_numpy
from sosvo_torch.sensor.model import annulus_mask
from sosvo_torch.synth import board as tboard

torch.set_num_threads(1)
NX, NY, SQ = 5, 4, 0.07
IMG = 1024
RENDER_EDGE_SHARE = 1e-3
SYM_RTOL = 1e-3


def _board_pose(rr, zz, az, tilt=0.0):
    """Board facing the rig: board x along world z, y azimuthal, its normal
    tilted by `tilt` toward the rig (tests/test_calib_corners.py's)."""
    center = np.array([rr * np.cos(az), rr * np.sin(az), zz])
    nrm = -center / np.linalg.norm(center)
    bx = np.array([0.0, 0.0, 1.0])
    by = np.cross(nrm, bx)
    by /= np.linalg.norm(by)
    bx = np.cross(by, nrm)
    c, s = np.cos(tilt), np.sin(tilt)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.stack([-s * nrm + c * bx, by, c * nrm + s * bx], axis=1)
    T[:3, 3] = center
    return T


@pytest.fixture(scope="module")
def captures():
    """(JAX nominal rig, JAX truth, port truth, poses, images rendered by the port)."""
    base = jax_default_rig(image_size=IMG)
    gt = base._replace(
        top=base.top._replace(fx=base.top.fx * 1.02, cx=base.top.cx + 3.0),
        bottom=base.bottom._replace(fy=base.bottom.fy * 0.98, cy=base.bottom.cy - 2.0,
                                    z_offset=base.bottom.z_offset * 1.08))
    tgt = rig_from_numpy(gt, "cpu")
    poses = [_board_pose(0.45, -0.2, 2 * np.pi * i / 5, tilt=0.1 * (i % 2)) for i in range(5)]
    images = np.stack([tboard.render_board_frame(tgt, torch.as_tensor(T), NX, NY, SQ).numpy()
                       for T in poses])
    return base, gt, tgt, poses, images


def test_checker_matches():
    rng = np.random.default_rng(0)
    x, y = (rng.uniform(-0.4, 0.4, 4096).astype(np.float32) for _ in range(2))
    ref = np.asarray(jboard._checker(jnp.asarray(x), jnp.asarray(y), NX, NY, SQ))
    np.testing.assert_array_equal(tboard._checker(torch.as_tensor(x), torch.as_tensor(y),
                                                  NX, NY, SQ).numpy(), ref)


def test_board_render_matches(captures):
    base, gt, _, poses, images = captures
    ref = np.asarray(jax.jit(lambda t: jboard.render_board_frame(gt, t, NX, NY, SQ))(
        jnp.asarray(poses[1])))
    d = np.abs(images[1] - ref)
    assert images.shape == (5, IMG, IMG) and images.dtype == np.float32
    assert (d > 1e-6).mean() <= RENDER_EDGE_SHARE and d.max() <= 0.25 + 1e-6, d.max()


@pytest.fixture(scope="module")
def reference_bundle(captures):
    """The JAX package's chain on the five captures from the nominal prior
    (run once: its eager operations compile on first use)."""
    base, _, _, _, images = captures
    return jc.board_observations_from_images(base, images, NX, NY, SQ)


def _masks(rig, size):
    from scipy.ndimage import binary_erosion

    return {name: binary_erosion(annulus_mask(getattr(rig, name), size, size).numpy(),
                                 iterations=4) for name in ("top", "bottom")}


def test_saddles_and_grids_equal(captures):
    """On equal images and masks: saddles, strengths and grown lattices
    equal the reference's, every lattice cell found."""
    base, _, tgt, _, images = captures
    masks = _masks(rig_from_numpy(base, "cpu"), IMG)
    for img in images[:2]:
        for name in ("top", "bottom"):
            pts, s = tc.detect_saddles(img, masks[name], max_corners=4 * NX * NY)
            ref_pts, ref_s = jc.detect_saddles(img, masks[name], max_corners=4 * NX * NY)
            np.testing.assert_array_equal(pts, ref_pts)
            np.testing.assert_array_equal(s, ref_s)
            g = tc.grow_grid(pts, NX, NY, s)
            ref_g = jc.grow_grid(ref_pts, NX, NY, ref_s)
            assert (g is None) == (ref_g is None)
            if g is not None:
                np.testing.assert_array_equal(g, ref_g)


def _equal_up_to_common_flip(tops, bots, ref_tops, ref_bots) -> bool:
    """Whether (tops, bots), (M, G, k) corner arrays in grid order, equal the
    reference's board by board up to one dihedral flip of the grid applied
    to both views."""
    def flips(a):
        g = np.asarray(a).reshape(NX, NY, -1)
        return [np.ascontiguousarray(jc._apply_sym(g, *sym)).reshape(NX * NY, -1)
                for sym in jc._SYMMETRIES]

    return all(any(np.array_equal(ft, np.asarray(rt)) and np.array_equal(fb, np.asarray(rb))
                   for ft, fb in zip(flips(t), flips(b)))
               for t, b, rt, rb in zip(tops, bots, ref_tops, ref_bots))


def test_resolve_symmetry_matches(captures, reference_bundle):
    base, _, _, _, images = captures
    rig = rig_from_numpy(base, "cpu")
    masks = _masks(rig, IMG)
    grids = {}
    for name in masks:
        pts, s = tc.detect_saddles(images[0], masks[name], max_corners=4 * NX * NY)
        grids[name] = tc.grow_grid(pts, NX, NY, s)
    assert grids["top"] is not None and grids["bottom"] is not None
    got = tc.resolve_symmetry(rig, make_board_grid(NX, NY, SQ, device="cpu"), grids["top"],
                              grids["bottom"])
    ref = jc.resolve_symmetry(base, jax_make_board_grid(NX, NY, SQ), grids["top"],
                              grids["bottom"])
    assert _equal_up_to_common_flip([got[0]], [got[1]], [ref[0]], [ref[1]])
    assert abs(got[2] - ref[2]) <= SYM_RTOL * ref[2]


def test_board_observations_match(captures, reference_bundle):
    """The whole chain on five captures from the nominal prior: the same
    boards kept, each board's corners and weights equal to the reference's
    up to a common flip of its grid."""
    base, _, _, _, images = captures
    ref = reference_bundle
    got = tc.board_observations_from_images(rig_from_numpy(base, "cpu"), torch.as_tensor(images),
                                            NX, NY, SQ)
    assert ref is not None and got is not None
    np.testing.assert_array_equal(got.pts_board.numpy(), np.asarray(ref.pts_board))
    assert got.uv_top.shape == ref.uv_top.shape

    def corners(o, view):
        uv, w = getattr(o, f"uv_{view}"), getattr(o, f"w_{view}")
        return np.concatenate([np.asarray(uv), np.asarray(w)[..., None]], axis=-1)

    assert _equal_up_to_common_flip(corners(got, "top"), corners(got, "bottom"),
                                    corners(ref, "top"), corners(ref, "bottom"))


def test_rig_recovered_from_board_images(captures):
    """Pixels to parameters with the port alone: corners from the nominal
    prior, then the joint fit recovers the perturbation (the reference
    test's bounds)."""
    base, gt, tgt, _, images = captures
    prior = rig_from_numpy(base, "cpu")
    obs = tc.board_observations_from_images(prior, images, NX, NY, SQ)
    assert obs is not None and obs.uv_top.shape[0] >= 3
    assert float(obs.w_top.sum()) >= 0.75 * obs.uv_top.shape[0] * NX * NY
    res = fit_rig_from_boards(prior, obs, iters=40)
    assert float(res.rms0_px) > 1.0
    assert float(res.rms_px) < 0.3, float(res.rms_px)
    assert abs(float(res.rig.top.fx - tgt.top.fx)) < 1.5
    assert abs(float(res.rig.top.cx - tgt.top.cx)) < 1.0
    assert abs(float(res.rig.bottom.fy - tgt.bottom.fy)) < 1.5
    assert abs(float(res.rig.bottom.cy - tgt.bottom.cy)) < 1.0
    assert abs(float(res.rig.bottom.z_offset - tgt.bottom.z_offset)) < 2e-3
