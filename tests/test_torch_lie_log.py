"""The log maps of `sosvo_torch.geom.lie` against the JAX package's.

`vee`, `mat_to_quat`, `so3_log` and `se3_log` on the same inputs, made with
numpy from a seed: random poses, and rotations of exactly 0, 1e-4, 1 and
pi - 1e-3 rad about random axes (the small-angle and near-pi branches).
Every output within 1e-6 absolute of the reference; exp(log(T)) gives T
back within 1e-5. Between 3e-4 and 3 rad `se3_log` is also held to the
reference evaluated in float64, within 1e-6: there the reference's own f32
closed form for V^-1 cancels (3.7 % of a translation residual at 1.2e-3
rad on c3's loop-closure graph, scripts/pgo_precision.py), and the
port's series does not. The forward-mode Jacobian of `se3_log` through its
small-angle guards is finite at the identity (the pose graph's residual
at convergence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.geom import lie as jlie
from sosvo_torch.geom import lie as tlie

ANGLES = (0.0, 1e-4, 1.0, np.pi - 1e-3)
TOL = 1e-6
CASES = ["random"] + [repr(a) for a in ANGLES]


def _axes(rng, n):
    a = rng.normal(size=(n, 3))
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _poses(kind: str) -> np.ndarray:
    """(16, 4, 4) float32 rigid transforms."""
    rng = np.random.default_rng(CASES.index(kind))
    if kind == "random":
        xi = rng.normal(size=(16, 6)) * np.array([1.0, 1.0, 1.0, 2.0, 2.0, 2.0])
    else:
        xi = np.concatenate([_axes(rng, 16) * float(kind), rng.normal(size=(16, 3))], axis=-1)
    return np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))


def _both(fn_name, x):
    ref = np.asarray(getattr(jlie, fn_name)(jnp.asarray(x)))
    got = getattr(tlie, fn_name)(torch.tensor(x)).numpy()
    return got, ref


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("fn_name", ["mat_to_quat", "so3_log"])
def test_rotation_logs_match_jax(fn_name, kind):
    R = _poses(kind)[:, :3, :3]
    got, ref = _both(fn_name, R)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", CASES)
def test_se3_log_matches_jax(kind):
    got, ref = _both("se3_log", _poses(kind))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_vee_inverts_hat_as_jax():
    w = np.random.default_rng(1).normal(size=(32, 3)).astype(np.float32)
    W = np.asarray(jlie.hat(jnp.asarray(w)))
    got, ref = _both("vee", W)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("kind", CASES)
def test_exp_of_log_round_trip(kind):
    T = torch.tensor(_poses(kind))
    back = tlie.se3_exp(tlie.se3_log(T))
    np.testing.assert_allclose(back.numpy(), T.numpy(), rtol=0, atol=1e-5)


def test_log_jacobian_finite_at_identity():
    """jacfwd of se3_log(exp(d) T) at d = 0 for T = I (every small-angle
    branch selected) is the identity, and finite near it, as JAX's."""
    for T in (np.eye(4, dtype=np.float32), _poses(repr(1e-4))[0]):
        ref = np.asarray(jax.jacfwd(lambda d: jlie.se3_log(jlie.se3_exp(d) @ jnp.asarray(T)))(
            jnp.zeros(6, jnp.float32)))
        Tt = torch.tensor(T)
        got = torch.func.jacfwd(lambda d: tlie.se3_log(tlie.se3_exp(d[None]) @ Tt[None])[0])(
            torch.zeros(6)).numpy()
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("angle", [3e-4, 1e-3, 3e-3, 1e-2, 0.1, 0.7, 0.71, 1.0, 3.0])
def test_se3_log_against_float64(angle):
    """Between the reference's small-angle threshold (1e-3 rad) and ~0.1 rad
    its f32 V^-1 coefficient cancels (`sosvo_torch.geom.lie.se3_log`); the
    port's f32 log stays within 1e-6 of the reference's evaluated in
    float64, on either side of its own series threshold (t^2 = 0.5), on
    poses with loop-edge-sized translations (~5 cm) and larger ones."""
    rng = np.random.default_rng(int(angle * 1e4))
    xi = np.concatenate([_axes(rng, 16) * angle,
                         rng.normal(size=(16, 3)) * np.repeat([[0.05], [1.0]], 8, axis=0)],
                        axis=-1)
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
    with jax.enable_x64(True):
        ref = np.asarray(jlie.se3_log(jnp.asarray(T, jnp.float64)))
    got = tlie.se3_log(torch.tensor(T)).double().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
