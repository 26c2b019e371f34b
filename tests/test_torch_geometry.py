"""The port's geometry against the JAX package on the same inputs.

Lie group, sensor model, triangulation, alignment, essential matrix, small
solvers, bearing refinement and both RANSACs. Inputs come from numpy seeds
and go to both packages as numpy arrays. Continuous outputs agree to 1e-5
(rtol and atol, f32: the two frameworks round reductions and small matmuls
differently by a few ulp). RANSAC takes the reference's own Gumbel draws
(`jax.random.gumbel(key, (H, K))`, what `sample_minimal_sets` draws), so the
best hypothesis, inlier mask and count must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.backend import refine as jrefine
from sosvo.backend import schur as jschur
from sosvo.geom import lie as jlie
from sosvo.geometry import align as jalign
from sosvo.geometry import essential as jess
from sosvo.geometry import ransac as jransac
from sosvo.geometry import triangulate as jtri
from sosvo.sensor import model as jmodel
from sosvo.sensor import rig as jrig
from sosvo_torch.backend import refine as trefine
from sosvo_torch.backend import schur as tschur
from sosvo_torch.convert import rig_from_numpy, view_from_numpy
from sosvo_torch.geom import lie as tlie
from sosvo_torch.geometry import align as talign
from sosvo_torch.geometry import essential as tess
from sosvo_torch.geometry import ransac as transac
from sosvo_torch.geometry import triangulate as ttri
from sosvo_torch.sensor import model as tmodel
from sosvo_torch.sensor import rig as trig

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, ref, **tol):
    np.testing.assert_allclose(_np(got), _np(ref), **(tol or TOL))


def f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def unit(rng, n):
    v = f32(rng, n, 3)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def both(fn_j, fn_t, *args):
    """Call the JAX function and the port on the same numpy arguments."""
    return (fn_j(*(jnp.asarray(a) for a in args)),
            fn_t(*(torch.tensor(np.asarray(a)) for a in args)))


def rand_pose(rng, angle=0.3, trans=0.5):
    xi = np.concatenate([f32(rng, 3, scale=angle), f32(rng, 3, scale=trans)])
    return np.asarray(jlie.se3_exp(jnp.asarray(xi)))


# --------------------------------------------------------------------------- lie

@pytest.mark.parametrize("scale", [1e-5, 1e-3, 0.5, 2.0])  # Taylor and closed-form branches
def test_exp_maps(scale):
    rng = np.random.default_rng(0)
    w = f32(rng, 16, 3, scale=scale)
    xi = f32(rng, 16, 6, scale=scale)
    close(*reversed(both(jlie.so3_exp, tlie.so3_exp, w)))
    close(*reversed(both(jlie.se3_exp, tlie.se3_exp, xi)))


def test_rigid_transform_helpers():
    rng = np.random.default_rng(1)
    T = np.stack([rand_pose(rng) for _ in range(8)])
    pts = f32(rng, 8, 20, 3, scale=3.0)
    close(*reversed(both(jlie.mat_inv, tlie.mat_inv, T)))
    close(*reversed(both(jlie.transform_points, tlie.transform_points, T, pts)))
    R2 = np.stack([rand_pose(rng)[:3, :3] for _ in range(8)])
    close(*reversed(both(jlie.geodesic_angle, tlie.geodesic_angle, T[:, :3, :3], R2)))
    close(*reversed(both(jlie.hat, tlie.hat, f32(rng, 5, 3))))


# ------------------------------------------------------------------------ sensor

def test_default_rig_is_bit_identical():
    ref = jrig.default_rig()
    got = trig.default_rig(device="cpu")
    for view in ("top", "bottom"):
        for f in jmodel.ViewParams._fields:
            assert np.float32(getattr(getattr(ref, view), f)) == getattr(got, view).__getattribute__(f).item(), (view, f)
    assert np.float32(ref.baseline) == got.baseline.item()
    assert (ref.image_height, ref.image_width) == (got.image_height, got.image_width)


@pytest.mark.parametrize("distorted", [False, True])
def test_project_and_lift(distorted):
    extra = dict(k1=-0.05, k2=0.01, p1=1e-3, p2=-5e-4, mis_rx=0.01, mis_ry=-0.02) if distorted else {}
    jview = jmodel.ViewParams.create(xi=0.96, fx=150.0, fy=151.0, cx=383.5, cy=383.0,
                                     min_elevation=-0.66, max_elevation=0.24, **extra)
    tview = view_from_numpy(jview, "cpu")
    rng = np.random.default_rng(2)
    pts = f32(rng, 200, 3, scale=3.0)
    uv_j, ok_j = jmodel.project(jview, jnp.asarray(pts))
    uv_t, ok_t = tmodel.project(tview, torch.from_numpy(pts))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    close(uv_t, uv_j, rtol=1e-5, atol=1e-3)  # pixels (hundreds): ~1e-5 relative
    ray_j, v_j = jmodel.lift(jview, uv_j)
    ray_t, v_t = tmodel.lift(tview, torch.tensor(np.asarray(uv_j)))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    close(ray_t, ray_j)


def test_rig_conversion_round_trip():
    ref = jrig.default_rig(image_size=512, baseline=0.1)
    got = rig_from_numpy(ref, "cpu")
    assert got.image_height == 512
    close(got.bottom.z_offset, ref.bottom.z_offset, rtol=0, atol=0)


# ------------------------------------------------------------------ triangulate

def test_midpoint_triangulate():
    rng = np.random.default_rng(3)
    X = f32(rng, 300, 3, scale=3.0)
    c_top = np.zeros(3, np.float32)
    c_bot = np.array([0, 0, -0.12], np.float32)
    r1 = X - c_top + f32(rng, 300, 3, scale=0.01)
    r2 = X - c_bot + f32(rng, 300, 3, scale=0.01)
    r1 = (r1 / np.linalg.norm(r1, axis=-1, keepdims=True)).astype(np.float32)
    r2 = (r2 / np.linalg.norm(r2, axis=-1, keepdims=True)).astype(np.float32)
    ref = jtri.midpoint_triangulate(r1, r2, c_top, c_bot, 0.004, 30.0, 0.08)
    got = ttri.midpoint_triangulate(*(torch.from_numpy(a) for a in (r1, r2, c_top, c_bot)),
                                    0.004, 30.0, 0.08)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert ref.valid.sum() > 50
    for name in ("points", "depth_top", "angle", "gap"):
        close(getattr(got, name), getattr(ref, name), **TOL)


# ------------------------------------------------------------------------ align

@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama(with_scale):
    rng = np.random.default_rng(4)
    src = f32(rng, 4, 50, 3, scale=2.0)
    T = np.stack([rand_pose(rng, 1.0, 1.0) for _ in range(4)])
    dst = (np.einsum("bij,bnj->bni", T[:, :3, :3], src) + T[:, None, :3, 3]
           + f32(rng, 4, 50, 3, scale=0.01)).astype(np.float32)
    w = (rng.random((4, 50)) < 0.8).astype(np.float32)
    Tj, sj = jalign.umeyama(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), with_scale)
    Tt, st = talign.umeyama(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
                            with_scale)
    close(Tt, Tj)
    close(st, sj)


def test_procrustes_and_three_point():
    rng = np.random.default_rng(5)
    M = f32(rng, 32, 3, 3)
    close(*reversed(both(jalign.procrustes_rotation, talign.procrustes_rotation, M)))
    src = f32(rng, 32, 3, 3, scale=2.0)
    dst = f32(rng, 32, 3, 3, scale=2.0)
    close(*reversed(both(jalign.rigid_from_three_points, talign.rigid_from_three_points, src, dst)))


# -------------------------------------------------------------------- essential

def _two_view(rng, n, outliers=0.0, noise=0.0):
    X = f32(rng, n, 3, scale=3.0)
    T = rand_pose(rng, 0.2, 0.4)
    r1 = X / np.linalg.norm(X, axis=-1, keepdims=True)
    X2 = X @ T[:3, :3].T + T[:3, 3]
    r2 = X2 / np.linalg.norm(X2, axis=-1, keepdims=True) + f32(rng, n, 3, scale=noise)
    bad = rng.random(n) < outliers
    r2[bad] = unit(rng, int(bad.sum()))
    r2 = r2 / np.linalg.norm(r2, axis=-1, keepdims=True)
    return r1.astype(np.float32), r2.astype(np.float32), T


def close_up_to_sign(got, ref):
    g, r = _np(got), _np(ref)
    sign = np.sign(np.sum(g * r, axis=(-2, -1), keepdims=True))
    np.testing.assert_allclose(g * sign, r, **TOL)


def test_fit_essential_fast_batched():
    """Minimal sets whose second-smallest normal-matrix eigenvalue sits near
    the fit's 1e-5 shift leave its two inverse iterations a mix of two
    eigenvectors, which amplifies f32 rounding differences by 1/gap in either
    implementation; the comparison keeps the well-separated sets."""
    rng = np.random.default_rng(6)
    sets = [_two_view(rng, 8) for _ in range(64)]
    r1 = np.stack([s[0] for s in sets])
    r2 = np.stack([s[1] for s in sets])
    a = np.einsum("hnj,hnk->hnjk", r2, r1).reshape(64, 8, 9).astype(np.float64)
    M = np.einsum("hni,hnj->hij", a, a)
    ev = np.linalg.eigvalsh(M / (np.trace(M, axis1=1, axis2=2)[:, None, None] / 9.0))
    keep = ev[:, 1] > 1e-3
    assert keep.sum() >= 8
    r1, r2 = r1[keep], r2[keep]
    w = np.ones(r1.shape[:2], np.float32)
    close_up_to_sign(*reversed(both(jess.fit_essential_fast, tess.fit_essential_fast, r1, r2, w)))


def test_fit_essential_refit_and_residuals():
    rng = np.random.default_rng(7)
    r1, r2, _ = _two_view(rng, 200, outliers=0.2, noise=1e-3)
    w = (rng.random(200) < 0.9).astype(np.float32)
    E_j, E_t = both(jess.fit_essential_refit, tess.fit_essential_refit, r1, r2, w)
    close_up_to_sign(E_t, E_j)
    E = np.asarray(E_j)
    close(*reversed(both(jess.epipolar_residual_angle, tess.epipolar_residual_angle, E, r1, r2)))
    E_h = np.stack([E, -E, E.T])
    close(*reversed(both(jess.epipolar_residual_sin_hyps, tess.epipolar_residual_sin_hyps,
                         E_h, r1, r2)))


def test_decompose_essential():
    rng = np.random.default_rng(8)
    r1, r2, T = _two_view(rng, 150, noise=5e-4)
    w = np.ones(150, np.float32)
    E = np.asarray(jess.fit_essential_refit(jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(w)))
    (R_j, t_j, s_j), (R_t, t_t, s_t) = both(jess.decompose_essential, tess.decompose_essential,
                                            E, r1, r2, w)
    close(R_t, R_j, **TOL)
    close(t_t, t_j, **TOL)
    assert float(s_t) == float(s_j)


# -------------------------------------------------------------- solvers, refine

def test_small_solvers():
    rng = np.random.default_rng(9)
    A = f32(rng, 10, 6, 6)
    H = (A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(6)).astype(np.float32)
    g = f32(rng, 10, 6)
    close(*reversed(both(jschur.solve6x6_spd, tschur.solve6x6_spd, H, g)), **TOL)
    close(*reversed(both(jschur.inv6x6_spd, tschur.inv6x6_spd, H)), **TOL)
    close(*reversed(both(jschur.inv3x3, tschur.inv3x3, H[:, :3, :3])), **TOL)


def test_refine_pose_bearings():
    rng = np.random.default_rng(10)
    pts = f32(rng, 300, 3, scale=3.0)
    T = rand_pose(rng, 0.05, 0.1)
    q = pts @ T[:3, :3].T + T[:3, 3]
    rays = q / np.linalg.norm(q, axis=-1, keepdims=True) + f32(rng, 300, 3, scale=2e-3)
    rays = (rays / np.linalg.norm(rays, axis=-1, keepdims=True)).astype(np.float32)
    w = (rng.random(300) < 0.9).astype(np.float32)
    T0 = (T @ rand_pose(rng, 0.01, 0.02)).astype(np.float32)
    ref = jrefine.refine_pose_bearings(jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(rays),
                                       jnp.asarray(w), iters=4)
    got = trefine.refine_pose_bearings(*(torch.from_numpy(a) for a in (T0, pts, rays, w)), iters=4)
    close(got, ref)


# ------------------------------------------------------------------------ ransac

def _rigid_problem(rng, k=256, outliers=0.25):
    pts_prev = f32(rng, k, 3, scale=2.5)
    pts_prev[:, :2] += np.sign(pts_prev[:, :2]) * 1.5
    T = rand_pose(rng, 0.05, 0.1)
    pts_curr = (pts_prev @ T[:3, :3].T + T[:3, 3] + f32(rng, k, 3, scale=0.01)).astype(np.float32)
    bad = rng.random(k) < outliers
    pts_curr[bad] = f32(rng, int(bad.sum()), 3, scale=3.0)
    rays = pts_curr / np.linalg.norm(pts_curr, axis=-1, keepdims=True)
    valid = rng.random(k) < 0.9
    return pts_prev, pts_curr, rays.astype(np.float32), valid


@pytest.mark.parametrize("seed", [11, 12])
def test_ransac_rigid_with_reference_draws(seed):
    rng = np.random.default_rng(seed)
    pts_prev, pts_curr, rays, valid = _rigid_problem(rng)
    key = jax.random.PRNGKey(seed)
    H = 128
    ref = jransac.ransac_rigid(key, jnp.asarray(pts_prev), jnp.asarray(pts_curr),
                               jnp.asarray(valid), rays_curr=jnp.asarray(rays), n_hyps=H,
                               angle_threshold=0.02, min_inliers=10)
    g = torch.tensor(np.asarray(jax.random.gumbel(key, (H, pts_prev.shape[0]))))
    got = transac.ransac_rigid(g, torch.from_numpy(pts_prev), torch.from_numpy(pts_curr),
                               torch.from_numpy(valid), torch.from_numpy(rays),
                               angle_threshold=0.02, min_inliers=10)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers) > 100
    assert bool(got.ok) == bool(ref.ok)
    close(got.model, ref.model, **TOL)


def test_sample_minimal_sets_with_reference_draws():
    rng = np.random.default_rng(13)
    valid = rng.random(64) < 0.7
    logits = f32(rng, 64)
    key = jax.random.PRNGKey(13)
    ref = jransac.sample_minimal_sets(key, jnp.asarray(valid), 32, 8, logits=jnp.asarray(logits))
    g = torch.tensor(np.asarray(jax.random.gumbel(key, (32, 64))))
    got = transac.sample_minimal_sets(g, torch.from_numpy(valid), 8, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert valid[got.numpy()].all()


def test_gumbel_draw_of_zero_is_finite():
    g = transac.gumbel_of_uniform(torch.tensor([0.0, 0.5, 1.0 - 2**-24]))
    assert torch.isfinite(g).all()
    g = transac.gumbel(torch.Generator().manual_seed(0), (8, 16), "cpu")
    assert g.shape == (8, 16) and torch.isfinite(g).all()


def test_ransac_essential_with_reference_draws():
    rng = np.random.default_rng(14)
    r1, r2, _ = _two_view(rng, 256, outliers=0.2, noise=5e-4)
    valid = rng.random(256) < 0.9
    key = jax.random.PRNGKey(14)
    H = 128
    ref, R_j, t_j = jransac.ransac_essential(key, jnp.asarray(r1), jnp.asarray(r2),
                                             jnp.asarray(valid), n_hyps=H, threshold=0.01,
                                             min_inliers=10)
    g = torch.tensor(np.asarray(jax.random.gumbel(key, (H, 256))))
    got, R_t, t_t = transac.ransac_essential(g, torch.from_numpy(r1), torch.from_numpy(r2),
                                             torch.from_numpy(valid), threshold=0.01,
                                             min_inliers=10)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers) > 100
    close(R_t, R_j, **TOL)
    close(t_t, t_j, **TOL)
