"""The port's synthetic scene against the JAX package's.

`observe_frame` gets the reference's landmarks, descriptors and random draws
(pixel noise, bit flips), so both packages observe the same world with the
same noise. Rows are paired by `lm_id`: the selection of the K visible
landmarks breaks priority ties by index in both, but pairing keeps the test
about observations rather than slot order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.synth import scene as jscene
from sosvo_torch.convert import desc_to_numpy, desc_to_torch, rig_from_numpy
from sosvo_torch.synth import scene as tscene

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def test_trajectory_matches():
    ref = np.asarray(jscene.make_trajectory(12))
    got = tscene.make_trajectory(12, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def _jax_draws(key, k, flip_prob):
    """The draws `sosvo.synth.scene.observe_frame` makes from `key`."""
    k_nt, k_nb, k_dt, k_db = jax.random.split(key, 4)
    zeros = jnp.zeros((k, jscene.DESC_WORDS), jnp.uint32)
    return tscene.ObservationDraws(
        noise_top=torch.tensor(np.asarray(jax.random.normal(k_nt, (k, 2)))),
        noise_bottom=torch.tensor(np.asarray(jax.random.normal(k_nb, (k, 2)))),
        flips_top=desc_to_torch(jscene.corrupt_descriptors(k_dt, zeros, flip_prob), "cpu"),
        flips_bottom=desc_to_torch(jscene.corrupt_descriptors(k_db, zeros, flip_prob), "cpu"),
    )


@pytest.mark.parametrize("frame,noise,flips", [(0, 0.0, 0.0), (3, 0.3, 0.02)])
def test_observe_frame_with_reference_draws(frame, noise, flips):
    k = 256
    rig = jax_default_rig()
    scene = jscene.make_scene(jax.random.PRNGKey(0), n_frames=5, n_landmarks=2048)
    key = jax.random.PRNGKey(10 + frame)
    ref = jscene.observe_frame(rig, scene, frame, k, key, pixel_noise=noise,
                               desc_flip_prob=flips)
    t_scene = tscene.Scene(landmarks=torch.tensor(np.asarray(scene.landmarks)),
                           lm_desc=desc_to_torch(scene.lm_desc, "cpu"),
                           poses=torch.tensor(np.asarray(scene.poses)))
    got = tscene.observe_frame(rig_from_numpy(rig, "cpu"), t_scene, frame, k,
                               _jax_draws(key, k, flips), pixel_noise=noise)

    ref_ids = np.asarray(ref.lm_id)
    got_ids = got.lm_id.numpy()
    assert (ref_ids >= 0).sum() > 200
    assert sorted(ref_ids[ref_ids >= 0]) == sorted(got_ids[got_ids >= 0])
    order_ref = np.argsort(ref_ids, kind="stable")
    order_got = np.argsort(got_ids, kind="stable")
    ids = ref_ids[order_ref]
    np.testing.assert_array_equal(got_ids[order_got], ids)
    m = ids >= 0
    for name in ("uv_top", "uv_bottom"):
        np.testing.assert_allclose(getattr(got, name).numpy()[order_got][m],
                                   np.asarray(getattr(ref, name))[order_ref][m],
                                   rtol=1e-5, atol=1e-3)  # pixels (hundreds)
    for name in ("ray_top", "ray_bottom"):
        np.testing.assert_allclose(getattr(got, name).numpy()[order_got][m],
                                   np.asarray(getattr(ref, name))[order_ref][m], **TOL)
    for name in ("desc_top", "desc_bottom"):
        np.testing.assert_array_equal(desc_to_numpy(getattr(got, name))[order_got][m],
                                      np.asarray(getattr(ref, name))[order_ref][m])
    np.testing.assert_array_equal(got.valid_top.numpy()[order_got], np.asarray(ref.valid_top)[order_ref])


def test_descriptor_flip_rate():
    gen = torch.Generator().manual_seed(0)
    flips = tscene.descriptor_flips(gen, (512, 8), 0.02, device="cpu")
    rate = sum(bin(int(x) & 0xFFFFFFFF).count("1") for x in flips.flatten()) / (512 * 256)
    assert abs(rate - 0.02) < 0.003, rate
    assert not tscene.descriptor_flips(gen, (4, 8), 0.0, device="cpu").any()


def test_observe_sequence_shapes():
    gen = torch.Generator().manual_seed(1)
    rig = rig_from_numpy(jax_default_rig(), "cpu")
    scene = tscene.make_scene(gen, n_frames=3, n_landmarks=1024, device="cpu")
    obs = tscene.observe_sequence(rig, scene, 128, gen, pixel_noise=0.3,
                                  desc_flip_prob=0.02)
    assert obs.ray_top.shape == (3, 128, 3) and obs.desc_top.dtype == torch.int32
    assert obs.valid.sum() > 3 * 100
    f1 = obs.frame(1)
    assert f1.lm_id.shape == (128,)
    norms = torch.linalg.vector_norm(f1.ray_top[f1.valid], dim=-1)
    torch.testing.assert_close(norms, torch.ones_like(norms))
