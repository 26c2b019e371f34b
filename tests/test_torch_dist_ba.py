"""Landmark-sharded Schur reduction and BA (`kernels/schur_cuda.py` with an
axis, `sosvo_torch.dist.ba_dist`) against the JAX package's sharded forms.

The JAX side runs on the 8-device virtual CPU mesh of tests/conftest.py;
the port's ranks are processes on the CPU (gloo), fed the same numpy
inputs. Bounds:
  * the shard-partial Schur reduction at D = 8 on `_make_window(PRNGKey(23))`
    against `reduce_camera_system_pallas(axis_name=...)` in interpret mode
    (tests/test_schur_pallas.py's sharded case): S and b_red within 1e-5 and
    the inverses within 1e-4 of their largest magnitudes;
  * `ba_solve_sharded` at D = 2 and 8 on `_make_window(PRNGKey(11))` with
    noise: against the JAX package's `ba_solve_sharded` on `model_mesh(8)`
    X within 1e-5 and landmarks within 1e-4 (tests/test_torch_ba.py's
    bounds), against the port's single-rank solve tests/test_ba_dist.py's
    (X 1e-4, landmarks 1e-3, cost 1e-6 + 1e-3 relative); every rank's
    outputs bit-equal; the collectives counted: the initial cost, then per
    iteration one all-reduce of the camera system and the Schur partials
    together and one of the candidate's cost (and with Huber IRLS one of
    the reweighted cost), and one all-gather of the landmarks.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sosvo.backend.ba import build_blocks as jax_build_blocks
from sosvo.dist.ba_dist import ba_solve_sharded as jax_ba_solve_sharded
from sosvo.dist.mesh import MODEL_AXIS, model_mesh
from sosvo.kernels.schur_pallas import reduce_camera_system_pallas
from sosvo_torch.backend.ba import ba_solve
from sosvo_torch.convert import ba_window_from_numpy
from sosvo_torch.dist.launch import launch
from tests.test_ba import _make_window

RANKS = "tests.torch_dist_ranks"


def _rel(a, b):
    b = np.asarray(b)
    return float(np.max(np.abs(np.asarray(a) - b))) / (float(np.max(np.abs(b))) + 1e-9)


def test_shard_partial_schur_matches_jax_sharded(devices8):
    win, _, _ = _make_window(jax.random.PRNGKey(23), pose_noise=0.02, lm_noise=0.03,
                             pixel_like_noise=2e-3)
    blocks = jax_build_blocks(win)[:5]
    lam = 1e-3
    fn = shard_map(
        functools.partial(reduce_camera_system_pallas, lam=lam, interpret=True,
                          axis_name=MODEL_AXIS),
        mesh=model_mesh(8),
        in_specs=(P(), P(None, MODEL_AXIS), P(MODEL_AXIS), P(), P(MODEL_AXIS)),
        out_specs=(P(), P(), P(MODEL_AXIS)), check_vma=False)
    S_ref, b_ref, inv_ref = fn(*blocks)
    tblocks = tuple(torch.tensor(np.asarray(b)) for b in blocks)
    outs = launch(f"{RANKS}:schur_shard", 8, dict(blocks=tblocks, lam=lam), device="cpu")
    S, b_red, inv = outs[0]
    assert _rel(S, S_ref) < 1e-5
    assert _rel(b_red, b_ref) < 1e-5
    assert _rel(inv, inv_ref) < 1e-4
    for o in outs[1:]:  # replicated outputs are bit-equal on every rank
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))


@pytest.fixture(scope="module")
def noisy_window():
    win, X_gt, _ = _make_window(jax.random.PRNGKey(11), pose_noise=0.02, lm_noise=0.03,
                                pixel_like_noise=2e-3)
    return win, X_gt


@pytest.mark.parametrize("world", [2, 8])
def test_ba_solve_sharded_matches_jax_and_single(noisy_window, devices8, world):
    win, X_gt = noisy_window
    ref = jax_ba_solve_sharded(model_mesh(8), win, iters=6)
    twin = ba_window_from_numpy(win, "cpu")
    single = ba_solve(twin, iters=6)
    outs = launch(f"{RANKS}:ba_sharded", world, dict(win=twin, iters=6), device="cpu")
    res, calls = outs[0]
    # against the JAX package's sharded solve
    assert float(np.max(np.abs(res.X.numpy() - np.asarray(ref.X)))) < 1e-5
    assert float(np.max(np.abs(res.landmarks.numpy() - np.asarray(ref.landmarks)))) < 1e-4
    # against the port's single-rank solve (tests/test_ba_dist.py's bounds)
    assert float(torch.max(torch.abs(res.X - single.X))) < 1e-4
    assert float(torch.max(torch.linalg.norm(res.landmarks - single.landmarks, dim=-1))) < 1e-3
    c = float(single.cost)
    assert abs(float(res.cost) - c) < 1e-6 + 1e-3 * c
    assert float(res.cost) < float(res.cost0)
    t_err = torch.linalg.norm(res.X[:, :3, 3] - torch.tensor(np.asarray(X_gt))[:, :3, 3], dim=-1)
    assert float(t_err.max()) < 0.02
    # every rank holds the same result, and the collectives are counted
    for o, _ in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, res))
    assert calls == {"model.psum": 1 + 6 * 2, "model.all_gather": 1}


def test_ba_solve_sharded_huber_on_2d_mesh(noisy_window):
    """The model axis of a 2 x 2 (data, model) mesh, with the Huber IRLS
    the replay's window solve uses; each data row solves alike."""
    win, _ = noisy_window
    twin = ba_window_from_numpy(win, "cpu")
    single = ba_solve(twin, iters=5, huber_delta=0.005)
    outs = launch(f"{RANKS}:ba_sharded", 4, dict(win=twin, iters=5, huber_delta=0.005, data=2),
                  device="cpu")
    res = outs[0][0]
    assert float(torch.max(torch.abs(res.X - single.X))) < 1e-4
    assert float(torch.max(torch.linalg.norm(res.landmarks - single.landmarks, dim=-1))) < 1e-3
    for o, calls in outs:
        assert all(torch.equal(a, b) for a, b in zip(o, res))
        assert calls == {"model.psum": 1 + 5 * 3, "model.all_gather": 1}
