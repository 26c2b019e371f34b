"""The renderer: `sosvo_torch.synth.render` against the JAX package's
`sosvo.synth.render`, and the sensor helpers it needs.

Same rig (`default_rig` at 192 and 384 px, and 768 for one frame) and poses
(`make_trajectory(6, radius=0.4)`, the CLI's room) through both packages.
The annulus masks must be equal. The lattice hash is integer arithmetic and
must be bit-equal on random lattice points, negative ones included. Pixels
must agree within 1e-5, except where a hit point lies within rounding of a
checker cell edge (the texture's `floor` can flip there between two f32
computations of the same point: the pixel then moves by the checker's 0.25):
such pixels are counted, each must sit within 1e-4 of a cell edge, and
there must be fewer than 0.1 % of them. The rotated directions must agree
within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.geom.lie import rotate_dirs as jax_rotate_dirs
from sosvo.sensor import model as jmodel
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.synth import render as jrender
from sosvo.synth.scene import make_trajectory as jax_make_trajectory
from sosvo_torch.convert import rig_from_numpy
from sosvo_torch.geom.lie import rotate_dirs
from sosvo_torch.sensor import model as tmodel
from sosvo_torch.synth import render as trender

torch.set_num_threads(1)
ROOM = jrender.RoomScene(radius=3.0, floor_z=-1.2, ceiling_z=1.6, texture_scale=2.0)
PIXEL_TOL = 1e-5
EDGE_TOL = 1e-4
MAX_EDGE_SHARE = 1e-3


@pytest.fixture(scope="module")
def poses():
    return np.asarray(jax_make_trajectory(6, radius=0.4))


def _rigs(size):
    rig = jax_default_rig(image_size=size)
    return rig, rig_from_numpy(rig, "cpu")


@pytest.mark.parametrize("size", [192, 384, 768])
def test_annulus_masks_and_bounds_match(size):
    rig, trig = _rigs(size)
    for name in ("top", "bottom"):
        jv, tv = getattr(rig, name), getattr(trig, name)
        np.testing.assert_array_equal(tmodel.annulus_mask(tv, size, size).numpy(),
                                      np.asarray(jmodel.annulus_mask(jv, size, size)))
        for a, b in zip(tmodel.annulus_bounds(tv), jmodel.annulus_bounds(jv)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        el = np.linspace(-0.6, 0.3, 11, dtype=np.float32)
        np.testing.assert_allclose(tmodel.radius_of_elevation(tv, torch.tensor(el)).numpy(),
                                   np.asarray(jmodel.radius_of_elevation(jv, jnp.asarray(el))),
                                   rtol=1e-6)


def test_rotate_dirs_matches():
    rng = np.random.default_rng(3)
    T = np.asarray(jax_make_trajectory(4, radius=0.4))
    dirs = rng.normal(size=(4, 50, 3)).astype(np.float32)
    for M in (T, T[:, :3, :3]):
        np.testing.assert_allclose(rotate_dirs(torch.tensor(M), torch.tensor(dirs)).numpy(),
                                   np.asarray(jax_rotate_dirs(jnp.asarray(M), jnp.asarray(dirs))),
                                   rtol=0, atol=1e-6)


def test_hash_is_bit_equal():
    rng = np.random.default_rng(0)
    ijk = rng.integers(-2**31, 2**31 - 1, size=(3, 20000)).astype(np.int32)
    ijk[:, :8] = [[0, -1, 1, -2**31, 2**31 - 1, 5, -7, 3]] * 3
    for seed in (1234, 1235, 2**31 + 5):
        ref = np.asarray(jrender._hash3(*(jnp.asarray(x) for x in ijk), seed))
        got = trender._hash3(*(torch.tensor(x) for x in ijk), seed).numpy()
        np.testing.assert_array_equal(got, ref)


def _edge_distance(trig, pose, scene):
    """Per pixel, the distance of the shading view's hit point (scaled as the
    checker scales it) to the nearest cell edge."""
    T = torch.tensor(pose)
    p_top, _, m_top = trender.hit_points(trig, T, trig.top, scene)
    p_bot, _, _ = trender.hit_points(trig, T, trig.bottom, scene)
    q = torch.where(m_top[..., None], p_top, p_bot) * (scene.texture_scale * 2)
    return torch.abs(q - torch.round(q)).min(dim=-1).values.numpy()


@pytest.mark.parametrize("size,frames", [(192, (0, 3, 5)), (384, (0, 5)), (768, (2,))])
def test_render_frame_matches(size, frames, poses):
    rig, trig = _rigs(size)
    scene = trender.RoomScene(*ROOM)
    ref_fn = jax.jit(lambda T: jrender.render_frame(rig, T, ROOM))
    for f in frames:
        ref = np.asarray(ref_fn(jnp.asarray(poses[f])))
        got = trender.render_frame(trig, torch.tensor(poses[f]), scene).numpy()
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got == 0.0, ref == 0.0)   # the same pixels lit
        off = np.abs(got - ref) > PIXEL_TOL
        share = off.mean()
        print(f"size {size} frame {f}: {off.sum()} pixels off by > {PIXEL_TOL} "
              f"({share:.2e}), max abs diff elsewhere {np.abs(got - ref)[~off].max():.2e}")
        assert share < MAX_EDGE_SHARE
        if off.any():
            assert _edge_distance(trig, poses[f], scene)[off].max() < EDGE_TOL


def test_render_sequence_is_frame_by_frame(poses):
    _, trig = _rigs(192)
    scene = trender.RoomScene(*ROOM)
    P = torch.tensor(poses[:3])
    seq = trender.render_sequence(trig, P, scene)
    assert seq.shape == (3, 192, 192)
    for f in range(3):
        assert torch.equal(seq[f], trender.render_frame(trig, P[f], scene))
