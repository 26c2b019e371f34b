"""Windowed BA: the port's `sosvo_torch.backend.ba` against the JAX package's.

Windows come from `tests/test_ba.py::_make_window` (W=5 keyframes, L=128
landmarks, perturbed poses and landmarks, optional bearing noise) and go to
both packages as numpy arrays. The normal-equation blocks agree to 1e-5
relative to each block's largest magnitude (the port's Jacobians are in
closed form, the reference's by `jax.jacfwd`); a whole `ba_solve` agrees on
the poses to 1e-4 and on the cost to 1e-6 + 1e-3 * cost, the tolerance of
`tests/test_schur_pallas.py` for a BA solve. On CPU tensors the Schur
reduction runs the kernel's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.backend import ba as jba
from sosvo_torch.backend import ba as tba
from sosvo_torch.convert import ba_window_from_numpy
from sosvo_torch.kernels import schur_cuda
from tests.test_ba import L, W, _make_window

torch.set_num_threads(1)


def _origin_window(seed):
    """tests/test_ba.py:118's case: keyframe 0 at the world origin and 8
    empty, zero-weighted landmark slots at the origin."""
    win, _, _ = _make_window(jax.random.PRNGKey(seed), pose_noise=0.02, lm_noise=0.02)
    return win._replace(
        X=win.X.at[0].set(jnp.eye(4, dtype=jnp.float32)),
        landmarks=jnp.concatenate([win.landmarks, jnp.zeros((8, 3), jnp.float32)]),
        rays=jnp.concatenate([win.rays, jnp.zeros((W, 8, 2, 3), jnp.float32)], axis=1),
        weights=jnp.concatenate([win.weights, jnp.zeros((W, 8, 2), jnp.float32)], axis=1))


WINDOWS = {
    "noisy": lambda: _make_window(jax.random.PRNGKey(5), pose_noise=0.02, lm_noise=0.03,
                                  pixel_like_noise=1e-3)[0],
    "clean": lambda: _make_window(jax.random.PRNGKey(1), pose_noise=0.02, lm_noise=0.03)[0],
    "origin_empty_slots": lambda: _origin_window(6),
}


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref))) / (float(np.max(np.abs(ref))) + 1e-12)


def _both(name):
    win = WINDOWS[name]()
    return win, ba_window_from_numpy(win, "cpu")


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_build_blocks_match(name):
    win, twin = _both(name)
    ref = jax.jit(jba.build_blocks)(win)
    got = tba.build_blocks(twin)
    for field, r, g in zip(("H_cc", "H_cl", "H_ll", "b_c", "b_l", "cost"), ref, got):
        assert bool(torch.isfinite(g).all()), field
        assert _rel(g, r) < 1e-5, (field, _rel(g, r))


@pytest.mark.parametrize("delta", [0.005, 0.01])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_cost_and_huber_weights_match(name, delta):
    win, twin = _both(name)
    np.testing.assert_allclose(float(tba.ba_cost(twin)), float(jba.ba_cost(win)), rtol=1e-5,
                               atol=1e-12)
    ref = np.asarray(jba.huber_weights(win, delta))
    got = tba.huber_weights(twin, delta).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert (got < 1.0).any() or name == "clean"  # the robust branch is exercised


@pytest.mark.parametrize("anchor", [0, 2])
def test_lm_step_matches(anchor):
    win, twin = _both("noisy")
    ref = jax.jit(lambda w: jba.lm_step(w, jnp.float32(1e-3), anchor=anchor))(win)
    got = tba.lm_step(twin, torch.tensor(1e-3), anchor=torch.tensor(anchor, dtype=torch.int32))
    np.testing.assert_allclose(got.X.numpy(), np.asarray(ref.X), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.landmarks.numpy(), np.asarray(ref.landmarks), rtol=0, atol=1e-4)
    # The gauge keyframe does not move at all.
    assert torch.equal(got.X[anchor], twin.X[anchor])


@pytest.mark.parametrize("huber", [None, 0.005], ids=["l2", "huber"])
@pytest.mark.parametrize("name", ["noisy", "origin_empty_slots"])
def test_ba_solve_matches(name, huber):
    win, twin = _both(name)
    ref = jax.jit(lambda w: jba.ba_solve(w, iters=5, huber_delta=huber))(win)
    schur_cuda.reset_launches()
    got = tba.ba_solve(twin, iters=5, huber_delta=huber)
    assert schur_cuda.launches == 0  # CPU tensors: the plain version
    assert float(np.max(np.abs(got.X.numpy() - np.asarray(ref.X)))) < 1e-4
    c = float(ref.cost)
    assert abs(float(got.cost) - c) < 1e-6 + 1e-3 * c, (float(got.cost), c)
    assert abs(float(got.cost0) - float(ref.cost0)) <= 1e-5 * float(ref.cost0)
    np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(ref.accepted))


def test_origin_keyframe_and_empty_slots_stay_finite():
    """Mirror of tests/test_ba.py::test_ba_window_with_origin_keyframe_and_empty_slots."""
    _, twin = _both("origin_empty_slots")
    res = tba.ba_solve(twin, iters=6)
    assert bool(torch.isfinite(res.cost)) and bool(torch.isfinite(res.X).all())
    assert bool(torch.isfinite(res.landmarks).all())
    assert bool(res.accepted.any())
    assert float(res.cost) < 0.5 * float(res.cost0)
    res_h = tba.ba_solve(twin, iters=6, huber_delta=0.005)
    assert bool(torch.isfinite(res_h.X).all())
    assert float(res_h.cost) < float(res_h.cost0)


def test_gauge_anchor_fixed_and_window_recovered():
    """Mirrors of tests/test_ba.py's anchor and recovery tests."""
    win, X_gt, lms = _make_window(jax.random.PRNGKey(4), pose_noise=0.02, lm_noise=0.02)
    twin = ba_window_from_numpy(win, "cpu")
    res = tba.ba_solve(twin, iters=6)
    assert float((res.X[0] - twin.X[0]).abs().max()) < 1e-6
    win, X_gt, lms = _make_window(jax.random.PRNGKey(1), pose_noise=0.02, lm_noise=0.03)
    res = tba.ba_solve(ba_window_from_numpy(win, "cpu"), iters=8)
    assert float(res.cost) < 1e-7
    t_err = np.linalg.norm(res.X.numpy()[:, :3, 3] - np.asarray(X_gt)[:, :3, 3], axis=-1)
    assert t_err.max() < 1e-3
    assert L == res.landmarks.shape[0]
