"""One view's calibration fit (`sosvo_torch.calib.fit`) and `scale_rig`
against the JAX package's, on the CPU.

Control points are drawn with numpy from a seed inside the view's band and
projected by the JAX package; both packages fit the same points from the
same perturbed start. `scale_rig` must be bit-equal. The residuals must
agree within RES_TOL of their largest magnitude and each Jacobian column
within JAC_TOL of its own, f32 rounding through the projection's trig,
but for the misalignment pair (JAC_TOL_MIS): at mis angles near 5e-4 rad
the misalignment rotation's (1 - cos t) / t^2 cancels in f32 in both
packages, and its derivative carries 1e-4 of relative rounding; a
few Gauss-Newton iterations take the same accept/reject steps and land
within PARAM_TOL (relative) of the reference's parameters. Recovery of
perturbed intrinsics, distortion and misalignment is held to ground truth
as tests/test_calib_fit.py holds the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sosvo.calib import fit as jfit
from sosvo.sensor.model import project as jax_project
from sosvo.sensor.rig import default_rig as jax_default_rig
from sosvo.sensor.rig import scale_rig as jax_scale_rig
from sosvo_torch.calib import fit as tfit
from sosvo_torch.convert import calib_result_from_numpy, rig_from_numpy, view_from_numpy
from sosvo_torch.sensor.model import project
from sosvo_torch.sensor.rig import default_rig, scale_rig

torch.set_num_threads(1)
RES_TOL = 1e-5
JAC_TOL = 1e-5
JAC_TOL_MIS = 2e-4
PARAM_TOL = 1e-5


def _control_points(view, seed: int, n: int = 400):
    """(N, 3) numpy points in the view's frustum, 0.5-5 m away."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(float(view.min_elevation) + 0.03, float(view.max_elevation) - 0.03, n)
    r = rng.uniform(0.5, 5.0, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el)], axis=-1).astype(np.float32)


def _perturbed(v):
    return v._replace(xi=v.xi * 1.05, fx=v.fx * 0.93, fy=v.fy * 1.04, cx=v.cx + 6.0,
                      cy=v.cy - 4.0)


def _problem(seed: int = 0):
    """(JAX view truth, its perturbed init, points, pixels, weights), numpy."""
    gt = jax_default_rig().top
    pts = _control_points(gt, seed)
    uv, ok = jax_project(gt, jnp.asarray(pts))
    return gt, _perturbed(gt), pts, np.asarray(uv), np.asarray(ok, np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("factor", [2.0, 0.5, 1536 / 768, 768 / 1536, 0.75, 4 / 3])
def test_scale_rig_bit_equal(factor):
    """Both views' intrinsics and the image size scale as the reference's,
    bit for bit, on the default rig and on a rig with every term set."""
    base = jax_default_rig()
    full = base._replace(top=base.top._replace(k1=jnp.float32(-0.02), mis_rx=jnp.float32(0.01),
                                               cx=base.top.cx + 1.5),
                         bottom=base.bottom._replace(fy=base.bottom.fy * 0.98,
                                                     cy=base.bottom.cy - 1.0))
    for rig in (base, full):
        ref = jax_scale_rig(rig, factor)
        got = scale_rig(rig_from_numpy(rig, "cpu"), factor)
        assert (got.image_height, got.image_width) == (ref.image_height, ref.image_width)
        for name in ("top", "bottom"):
            for f in got.top._fields:
                a = getattr(getattr(got, name), f).numpy()
                b = np.asarray(getattr(getattr(ref, name), f))
                assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), (name, f)
        assert np.array_equal(got.baseline.numpy(), np.asarray(ref.baseline))


def test_scale_rig_round_trip_on_device_of_rig():
    rig = default_rig(device="cpu")
    up = scale_rig(rig, 2.0)
    assert up.top.fx.device.type == "cpu" and up.image_height == 1536
    back = scale_rig(up, 0.5)
    for f in ("fx", "fy", "cx", "cy"):
        assert float(getattr(back.top, f)) == float(getattr(rig.top, f))


def test_parameter_vector_matches():
    gt, init, *_ = _problem()
    v = view_from_numpy(init, "cpu")
    p = tfit.params_to_vector(v)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jfit.params_to_vector(init)))
    back = tfit.vector_to_params(p, v)
    assert all(torch.equal(a, b) for a, b in zip(back, v))


def test_residuals_and_jacobian_match():
    """At a start with every parameter nudged (distortion and misalignment
    too): residuals within RES_TOL of their largest magnitude and each
    Jacobian column within JAC_TOL of its largest entry; the port's
    Jacobian stays f32."""
    gt, init, pts, uv, w = _problem()
    rng = np.random.default_rng(1)
    p = np.asarray(jfit.params_to_vector(init)) + rng.normal(0, 1e-3, 12).astype(np.float32)
    args = (init, jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(w))
    r_ref = np.asarray(jfit._residuals(jnp.asarray(p), *args))
    J_ref = np.asarray(jax.jacfwd(jfit._residuals)(jnp.asarray(p), *args))
    tv = view_from_numpy(init, "cpu")
    targs = (tv, _t(pts), _t(uv), _t(w))
    r = tfit._residuals(_t(p), *targs).numpy()
    J = torch.func.jacfwd(lambda q: tfit._residuals(q, *targs))(_t(p))
    assert J.dtype == torch.float32 and J.shape == J_ref.shape
    assert np.abs(r - r_ref).max() <= RES_TOL * np.abs(r_ref).max()
    col = np.abs(J_ref).max(axis=0)
    tol = np.full(12, JAC_TOL)
    tol[10:] = JAC_TOL_MIS
    assert (np.abs(J.numpy() - J_ref).max(axis=0) <= tol * col + 1e-6).all()


@pytest.mark.parametrize("iters", [3, 25])
def test_fit_view_iterations_match(iters):
    """A few damped Gauss-Newton steps and a converged fit: the same
    accept/reject trace, parameters within PARAM_TOL relative, rms within
    5e-5 px."""
    gt, init, pts, uv, w = _problem()
    ref = jax.jit(lambda: jfit.fit_view(init, jnp.asarray(pts), jnp.asarray(uv),
                                        weights=jnp.asarray(w), iters=iters))()
    got = tfit.fit_view(view_from_numpy(init, "cpu"), _t(pts), _t(uv), weights=_t(w), iters=iters)
    assert got.accepted.tolist() == np.asarray(ref.accepted).tolist()
    a, b = tfit.params_to_vector(got.view).numpy(), np.asarray(jfit.params_to_vector(ref.view))
    assert (np.abs(a - b) <= PARAM_TOL * np.maximum(np.abs(b), 1.0)).all(), a - b
    assert abs(float(got.rms_px) - float(ref.rms_px)) < 5e-5
    assert abs(float(got.rms0_px) - float(ref.rms0_px)) <= 1e-5 * float(ref.rms0_px)
    conv = calib_result_from_numpy(ref, "cpu")
    assert conv.accepted.tolist() == got.accepted.tolist()


def _port_problem(view, seed):
    pts = torch.as_tensor(_control_points(view, seed, n=600 if seed == 3 else 400))
    uv, ok = project(view, pts)
    return pts, uv, ok.float()


def test_fit_recovers_perturbed_intrinsics():
    gt = default_rig(device="cpu").top
    pts, uv, w = _port_problem(gt, 0)
    res = tfit.fit_view(_perturbed(gt), pts, uv, weights=w, iters=25)
    assert float(res.rms0_px) > 1.0
    assert float(res.rms_px) < 1e-2, float(res.rms_px)
    assert abs(float(res.view.xi - gt.xi)) < 1e-3
    assert abs(float(res.view.fx - gt.fx)) < 0.2
    assert abs(float(res.view.cx - gt.cx)) < 0.05


def test_fit_recovers_distortion_and_misalignment():
    """Nonzero radial/tangential distortion and mirror misalignment come
    back from a zero-terms start (the reference's tolerances)."""
    rig = default_rig(device="cpu")
    f32 = torch.tensor
    gt = rig.top._replace(k1=f32(-0.02), k2=f32(1e-3), p1=f32(6e-4), p2=f32(-4e-4),
                          mis_rx=f32(0.012), mis_ry=f32(-0.009))
    pts, uv, w = _port_problem(gt, 3)
    res = tfit.fit_view(rig.top, pts, uv, weights=w, iters=40, fit_distortion=True,
                        fit_misalignment=True)
    assert float(res.rms0_px) > 0.5 and float(res.rms_px) < 2e-2, (res.rms0_px, res.rms_px)
    assert abs(float(res.view.k1 - gt.k1)) < 5e-3
    assert abs(float(res.view.k2 - gt.k2)) < 5e-3
    assert abs(float(res.view.mis_rx - gt.mis_rx)) < 5e-4
    assert abs(float(res.view.mis_ry - gt.mis_ry)) < 5e-4


def test_fit_noisy_observations():
    gt = default_rig(device="cpu").bottom
    pts, uv, w = _port_problem(gt, 1)
    uv = uv + 0.3 * torch.as_tensor(np.random.default_rng(2).normal(size=uv.shape), dtype=torch.float32)
    init = gt._replace(fx=gt.fx * 1.08, cx=gt.cx - 5.0)
    res = tfit.fit_view(init, pts, uv, weights=w, iters=25)
    # sqrt(E|r|^2) for two components of sigma 0.3 is ~0.42 px
    assert float(res.rms_px) < 0.5
    assert abs(float(res.view.fx - gt.fx)) < 0.5
