"""Chessboard rig calibration (`sosvo_torch.calib.boards`) against the JAX
package's `sosvo.calib.boards`, on the CPU.

Boards face the rig around it (numpy, from a seed), their corners projected
through both views. Parity on the same corners and priors: the board grid
and the closed-form pose init (triangulate + Umeyama, within INIT_TOL m),
the packed parameters, the residuals (RES_TOL of their largest magnitude)
and the Jacobian (each column within JAC_TOL of its largest entry; the
misalignment columns within JAC_TOL_MIS, the (1 - cos t) / t^2 cancellation
of tests/test_torch_calib_fit.py), three damped Gauss-Newton iterations,
plain and with the staged recipe's options (frozen xi, Huber IRLS, the
misalignment prior): the same accept/reject trace, intrinsics within
PARAM_TOL relative and poses within POSE_TOL; mid-fit the two f32 paths
part (by 1-2 % after 10 iterations, accept/reject flips included), so the
converged fit (40 iterations) is held to CONVERGED_TOL relative instead of
step by step. Recovery is held to ground truth as
tests/test_calib_boards.py holds the reference: intrinsics and baseline
from perturbed priors, the staged full-GUM recipe on 9 boards (the
reference's test takes 18), noisy corners to the noise floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.calib import boards as jb
from sosvo.geom.lie import se3_log as jax_se3_log
from sosvo.sensor.model import project as jax_project
from sosvo.sensor.model import viewpoint as jax_viewpoint
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo_torch.calib import boards as tb
from sosvo_torch.convert import (board_observations_from_numpy, rig_calib_result_from_numpy,
                                 rig_from_numpy)
from sosvo_torch.geom.lie import se3_exp
from sosvo_torch.sensor.model import lift, project, viewpoint
from sosvo_torch.sensor.rig import default_rig

torch.set_num_threads(1)
INIT_TOL = 1e-4
RES_TOL = 1e-5
JAC_TOL = 1e-5
JAC_TOL_MIS = 2e-4
PARAM_TOL = 5e-4
POSE_TOL = 5e-4
CONVERGED_TOL = 5e-5
INTR = ("xi", "fx", "fy", "cx", "cy", "z_offset", "k1", "k2", "p1", "p2", "mis_rx", "mis_ry")


def _board_poses(m: int, seed: int, ranges=(1.5,), heights=(-0.25,)) -> np.ndarray:
    """(M, 4, 4) rig-from-board poses facing the rig, spread in azimuth, with
    a small random tilt (tests/test_calib_boards.py's layout, in numpy)."""
    rng = np.random.default_rng(seed)

    def rot(w):
        return se3_exp(torch.tensor(np.concatenate([w, np.zeros(3)]), dtype=torch.float32)
                       ).numpy()[:3, :3]

    poses = []
    for i in range(m):
        az = 2 * np.pi * i / m
        rr, zz = ranges[i % len(ranges)], heights[(i // len(ranges)) % len(heights)]
        T = np.eye(4, dtype=np.float32)
        tilt = rng.normal(0.0, 0.08, 3)
        T[:3, :3] = rot(np.array([0.0, 0.0, az + np.pi])) @ rot(np.array([np.pi / 2, 0, 0]) + tilt)
        T[:3, 3] = [rr * np.cos(az), rr * np.sin(az), zz]
        poses.append(T)
    return np.stack(poses)


def _grid():
    return tb.make_board_grid(7, 5, 0.06, device="cpu")


def _port_obs(rig, poses: np.ndarray) -> tb.BoardObservations:
    """The boards' corners projected through the port's rig."""
    grid = _grid()
    P = torch.as_tensor(poses)
    pts = torch.einsum("mij,gj->mgi", P[:, :3, :3], grid) + P[:, None, :3, 3]
    uv_t, ok_t = project(rig.top, pts - viewpoint(rig.top))
    uv_b, ok_b = project(rig.bottom, pts - viewpoint(rig.bottom))
    return tb.BoardObservations(grid, uv_t, ok_t.float(), uv_b, ok_b.float())


def _jax_obs(rig, poses: np.ndarray) -> jb.BoardObservations:
    """The same through the JAX package's rig (its grid, numpy poses)."""
    grid = jb.make_board_grid(nx=7, ny=5, square=0.06)
    P = jnp.asarray(poses)
    pts = jnp.einsum("mij,gj->mgi", P[:, :3, :3], grid) + P[:, None, :3, 3]
    uv_t, ok_t = jax_project(rig.top, pts - jax_viewpoint(rig.top))
    uv_b, ok_b = jax_project(rig.bottom, pts - jax_viewpoint(rig.bottom))
    return jb.BoardObservations(grid, uv_t, ok_t.astype(jnp.float32), uv_b,
                                ok_b.astype(jnp.float32))


def _perturbed(gt):
    return gt._replace(
        top=gt.top._replace(xi=gt.top.xi * 1.04, fx=gt.top.fx * 0.95, cx=gt.top.cx + 4.0),
        bottom=gt.bottom._replace(fy=gt.bottom.fy * 1.06, cy=gt.bottom.cy - 3.0,
                                  z_offset=gt.bottom.z_offset * 1.15))


@pytest.fixture(scope="module")
def problem():
    """(JAX init rig, JAX observations, port init rig, port observations,
    true poses) of 6 boards at 1.5 m, the init perturbed as the reference's
    test perturbs it."""
    gt = jax_default_rig()
    poses = _board_poses(6, 0)
    obs = _jax_obs(gt, poses)
    init = _perturbed(gt)
    return init, obs, rig_from_numpy(init, "cpu"), board_observations_from_numpy(obs, "cpu"), poses


def test_make_board_grid_matches():
    for nx, ny, sq in ((7, 5, 0.06), (5, 4, 0.07), (8, 6, 0.04)):
        np.testing.assert_array_equal(tb.make_board_grid(nx, ny, sq, device="cpu").numpy(),
                                      np.asarray(jb.make_board_grid(nx, ny, sq)))


def test_init_board_poses_match(problem):
    """The closed-form init: within INIT_TOL of the reference's and, on the
    true rig, within 2 cm of the true poses (the reference's bound)."""
    init, obs, tinit, tobs, poses = problem
    ref = np.asarray(jb.init_board_poses(init, obs))
    got = tb.init_board_poses(tinit, tobs).numpy()
    assert np.abs(got - ref).max() < INIT_TOL
    gt = default_rig(device="cpu")
    assert float(torch.min(torch.sum(tobs.w_top * tobs.w_bottom, dim=1))) >= 10
    T0 = tb.init_board_poses(gt, tobs).numpy()
    assert np.linalg.norm(T0[:, :3, 3] - poses[:, :3, 3], axis=1).max() < 0.02


def test_residuals_and_jacobian_match(problem):
    init, obs, tinit, tobs, _ = problem
    T0 = jb.init_board_poses(init, obs)
    p_ref = jb._pack(init, jax.vmap(jax_se3_log)(T0))
    p = tb._pack(tinit, torch.as_tensor(np.array(jax.vmap(jax_se3_log)(T0))))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    r_ref = np.asarray(jb._residuals(p_ref, init, obs))
    J_ref = np.asarray(jax.jit(lambda q: jax.jacfwd(jb._residuals)(q, init, obs))(p_ref))
    r = tb._residuals(p, tinit, tobs).numpy()
    J = torch.func.jacfwd(lambda q: tb._residuals(q, tinit, tobs))(p)
    assert J.dtype == torch.float32 and J.shape == J_ref.shape
    assert np.abs(r - r_ref).max() <= RES_TOL * np.abs(r_ref).max()
    tol = np.full(J.shape[1], JAC_TOL)
    tol[list(tb._MIS_IDX)] = JAC_TOL_MIS
    col = np.abs(J_ref).max(axis=0)
    assert (np.abs(J.numpy() - J_ref).max(axis=0) <= tol * col + 1e-6).all()


def _params(rig):
    return np.array([float(getattr(getattr(rig, v), f)) for v in ("top", "bottom") for f in INTR])


@pytest.mark.parametrize("options", ["plain", "staged_stage2"])
def test_gn_iterations_match(problem, options):
    """Three iterations from the perturbed prior: the reference's
    accept/reject trace, poses within POSE_TOL, intrinsics within PARAM_TOL
    relative, rms within 1e-3 relative. "staged_stage2" is the
    staged recipe's second stage on noisy corners: xi frozen, distortion and
    misalignment free, Huber IRLS at 2 px and the misalignment prior
    anchored at the design values."""
    init, obs, tinit, tobs, _ = problem
    kw = {}
    if options == "staged_stage2":
        rng = np.random.default_rng(4)
        noise = [rng.normal(0, 0.5, np.shape(obs.uv_top)).astype(np.float32) for _ in range(2)]
        obs = obs._replace(uv_top=obs.uv_top + noise[0], uv_bottom=obs.uv_bottom + noise[1])
        tobs = board_observations_from_numpy(obs, "cpu")
        kw = dict(fit_distortion=True, fit_misalignment=True, fit_xi=False, huber_delta_px=2.0,
                  mis_prior_px_per_rad=30.0, mis_anchor=np.zeros(4, np.float32))
    ref = jax.jit(lambda: jb.fit_rig_from_boards(init, obs, iters=3, **kw))()
    got = tb.fit_rig_from_boards(tinit, tobs, iters=3, **kw)
    assert got.accepted.tolist() == np.asarray(ref.accepted).tolist()
    a, b = _params(got.rig), _params(ref.rig)
    assert (np.abs(a - b) <= PARAM_TOL * np.maximum(np.abs(b), 1.0)).all(), a - b
    assert np.abs(got.poses.numpy() - np.asarray(ref.poses)).max() < POSE_TOL
    for x, y in ((got.rms_px, ref.rms_px), (got.rms0_px, ref.rms0_px)):
        assert abs(float(x) - float(y)) <= 1e-3 * float(y)
    conv = rig_calib_result_from_numpy(ref, "cpu")
    assert conv.rig.image_height == got.rig.image_height and conv.poses.shape == got.poses.shape


def test_converged_fit_matches(problem):
    """40 iterations, as the reference's recovery test runs: both converge
    to the same rig (intrinsics within CONVERGED_TOL relative) at the same
    rms class."""
    init, obs, tinit, tobs, _ = problem
    ref = jax.jit(lambda: jb.fit_rig_from_boards(init, obs, iters=40))()
    got = tb.fit_rig_from_boards(tinit, tobs, iters=40)
    a, b = _params(got.rig), _params(ref.rig)
    assert (np.abs(a - b) <= CONVERGED_TOL * np.maximum(np.abs(b), 1.0)).all(), a - b
    assert np.abs(got.poses.numpy() - np.asarray(ref.poses)).max() < 1e-4
    assert max(float(got.rms_px), float(ref.rms_px)) < 5e-2


def test_joint_fit_recovers_intrinsics_and_baseline():
    gt = default_rig(device="cpu")
    obs = _port_obs(gt, _board_poses(6, 0))
    res = tb.fit_rig_from_boards(_perturbed(gt), obs, iters=40)
    assert float(res.rms0_px) > 1.0
    assert float(res.rms_px) < 5e-2, float(res.rms_px)
    assert abs(float(res.rig.top.xi - gt.top.xi)) < 2e-3
    assert abs(float(res.rig.top.fx - gt.top.fx)) < 0.5
    assert abs(float(res.rig.bottom.cy - gt.bottom.cy)) < 0.1
    # the metric baseline from the board scale: the 15 % perturbation back to 1 mm
    assert abs(float(res.rig.bottom.z_offset - gt.bottom.z_offset)) < 1e-3


def test_full_gum_recovers_distortion_and_misalignment():
    """The staged recipe from the nominal rig (every GUM term zero) on 9
    boards over three ranges and heights: the reference's bounds on the
    identifiable terms, and the fitted model projects and lifts like the
    truth on held-out points across the sampled band (xi and k1 share a
    radial gauge, so the radial terms are held functionally)."""
    base = default_rig(device="cpu")
    t = torch.tensor
    gt = base._replace(
        top=base.top._replace(k1=t(-0.015), k2=t(8e-4), p1=t(4e-4), mis_ry=t(0.008)),
        bottom=base.bottom._replace(k1=t(0.012), p2=t(-3e-4), mis_rx=t(-0.006)))
    obs = _port_obs(gt, _board_poses(9, 5, ranges=(1.0, 1.6, 2.4), heights=(-0.55, -0.25, 0.05)))
    res = tb.fit_rig_full_gum(base, obs)
    assert float(res.rms0_px) > 0.3 and float(res.rms_px) < 2e-2, (res.rms0_px, res.rms_px)
    assert abs(float(res.rig.top.mis_ry - gt.top.mis_ry)) < 1e-3
    assert abs(float(res.rig.bottom.mis_rx - gt.bottom.mis_rx)) < 1e-3
    assert abs(float(res.rig.top.p1 - gt.top.p1)) < 3e-4
    rng = np.random.default_rng(11)
    az, el, r = rng.uniform(-np.pi, np.pi, 800), rng.uniform(-0.45, 0.05, 800), \
        rng.uniform(0.9, 2.6, 800)
    pts = torch.tensor(np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                                 r * np.sin(el)], -1), dtype=torch.float32)
    for v_fit, v_gt in ((res.rig.top, gt.top), (res.rig.bottom, gt.bottom)):
        uv_f, ok_f = project(v_fit, pts - viewpoint(v_gt))
        uv_g, ok_g = project(v_gt, pts - viewpoint(v_gt))
        ok = ok_f & ok_g
        assert float(torch.where(ok[:, None], uv_f - uv_g, 0.0).abs().max()) < 0.15
        ray_f, _ = lift(v_fit, uv_g)
        ray_g, _ = lift(v_gt, uv_g)
        assert float(torch.where(ok, (ray_f - ray_g).norm(dim=-1), 0.0).max()) < 1e-3


def test_full_gum_keeps_the_lower_rms_start():
    """The multi-start pick is a device-side select, leaf by leaf."""
    rig = default_rig(device="cpu")
    a = tb.RigCalibResult(rig, torch.zeros(2, 4, 4), torch.tensor(1.0), torch.tensor(5.0),
                          torch.ones(3, dtype=torch.bool))
    b = a._replace(rig=rig._replace(top=rig.top._replace(fx=rig.top.fx + 1.0)),
                   poses=torch.ones(2, 4, 4), rms_px=torch.tensor(0.5))
    for better_a, want in ((torch.tensor(True), a), (torch.tensor(False), b)):
        got = tb._pick(better_a, a, b)
        assert torch.equal(got.rig.top.fx, want.rig.top.fx) and torch.equal(got.poses, want.poses)
        assert got.rig.image_height == rig.image_height


def test_noisy_corners_converge_to_noise_floor():
    """0.2 px of corner noise: the fit reaches the noise floor, and lands
    where the reference's fit of the same noisy corners lands (fx within
    0.05 px). Where along the xi-f near-gauge it lands depends on the noise
    draw in both packages alike (fx 142.95-151.49 px over four draws, truth
    150), so the reference's own draw-specific fx bound is held as parity."""
    gt = jax_default_rig()
    obs = _jax_obs(gt, _board_poses(6, 2))
    rng = np.random.default_rng(3)
    noisy = obs._replace(
        uv_top=obs.uv_top + 0.2 * rng.normal(size=np.shape(obs.uv_top)).astype(np.float32),
        uv_bottom=obs.uv_bottom + 0.2 * rng.normal(size=np.shape(obs.uv_bottom)).astype(np.float32))
    init = gt._replace(top=gt.top._replace(fx=gt.top.fx * 1.05))
    ref = jax.jit(lambda: jb.fit_rig_from_boards(init, noisy, iters=40))()
    res = tb.fit_rig_from_boards(rig_from_numpy(init, "cpu"),
                                 board_observations_from_numpy(noisy, "cpu"), iters=40)
    # sqrt(E|r|^2) for two components of sigma 0.2 is ~0.28 px
    assert float(res.rms_px) < 0.35, float(res.rms_px)
    assert abs(float(res.rms_px) - float(ref.rms_px)) < 1e-4
    assert abs(float(res.rig.top.fx) - float(ref.rig.top.fx)) < 0.05
