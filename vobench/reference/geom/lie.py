"""SO(3)/SE(3) Lie-group math on tensors (counterpart of `sosvo/geom/lie.py`).

Conventions as in the reference: right-handed frames, 4x4 homogeneous
matrices, tangent vectors (omega, v) with the rotational part first. Every
function broadcasts over leading batch dims and is f32-safe: small-angle
branches are `torch.where` selects between the closed form and a Taylor
expansion, never Python control flow on values.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm as sqrt(sum(x * x)), the reduction `jnp.linalg.norm` uses."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: 3-vector -> skew-symmetric 3x3 matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _sinc_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) from theta^2.

    Taylor fallbacks for theta^2 < 1e-6, exact enough in f32; the generic
    branch's argument is clamped away from zero so it stays finite where the
    Taylor branch is selected.
    """
    small = theta2 < 1e-6
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    return a, b, c


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) (Rodrigues), batched over leading dims."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta2)
    W = hat(w)
    return _eye3_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3). xi = (omega[3], v[3]) -> 4x4."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    a, b, c = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = _eye3_like(W)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def _sqrt_rounded(x: torch.Tensor) -> torch.Tensor:
    """f32 square root rounded correctly (through float64), as XLA's is;
    torch's vectorised CPU sqrt can be one f32 step off."""
    return torch.sqrt(x.double()).float()


def _unit_xla(q: torch.Tensor) -> torch.Tensor:
    """`q` over its norm, rounded as the JAX package's compiled CPU code
    rounds it: the squared norm takes one fused multiply-add per term (each
    emulated in float64 and rounded to f32 once), the root is correctly
    rounded. A quaternion normalised here carries the reference's bits."""
    wide = q.double()
    sq = (wide[..., 0] * wide[..., 0]).float()
    for i in range(1, q.shape[-1]):
        sq = (wide[..., i] * wide[..., i] + sq.double()).float()
    return q / torch.clamp_min(_sqrt_rounded(sq)[..., None], _EPS)


def mat_to_quat(R: torch.Tensor, xla_rounding: bool = False) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), branch-free (Shepperd).

    All four candidate quaternions are formed and the one keyed by the
    largest of (trace, m00, m11, m22) is gathered (the first on ties, as
    `jnp.argmax`); the sign is canonicalised to w >= 0. `xla_rounding`
    takes every root and the norm as the JAX package's CPU code rounds
    them (`_sqrt_rounded`, `_unit_xla`): the TUM writer's choice, whose
    text is compared with the reference's.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    root = _sqrt_rounded if xla_rounding else torch.sqrt

    def safe_sqrt(x):
        return root(torch.clamp_min(x, _EPS))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1)

    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = _unit_xla(q) if xla_rounding else q / torch.clamp_min(norm(q, keepdim=True), _EPS)
    return q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3) through the Shepperd quaternion:
    w = 2 atan2(|q_vec|, q_w) q_vec / |q_vec|, with 2 / q_w as the scale
    where |q_vec| < 1e-6 (both branches finite, so `where` selects)."""
    q = mat_to_quat(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    vn = norm(qv)
    theta = 2.0 * torch.atan2(vn, qw)
    small = vn < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp_min(qw, 0.5),
                        theta / torch.where(small, torch.ones_like(vn), vn))
    return scale[..., None] * qv


def _vinv_coef(theta2: torch.Tensor) -> torch.Tensor:
    """V^-1's W^2 coefficient, (1 - (t/2) cot(t/2)) / t^2, from t^2: its
    series 1/12 + t^2/720 + t^4/30240 where t^2 < 0.5, the half-angle form
    above; within 2.2e-6 relative in f32 at every angle.

    The reference's closed form (1 - A / (2B)) / t^2, which it uses from
    t^2 = 1e-6 up, takes 1 - cos t in f32 and cancels: at t ~ 1e-3 rad it
    is off by up to 6.9e5 times (scripts/pgo_precision.py)."""
    small = theta2 < 0.5
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    half = 0.5 * torch.sqrt(theta2_safe)
    closed = (1.0 - half * torch.cos(half) / torch.sin(half)) / theta2_safe
    return torch.where(small, 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0, closed)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Logarithm map SE(3) -> se(3): 4x4 -> (omega, v), with
    V^-1 = I - W/2 + coef W^2 (`_vinv_coef`)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    W = hat(w)
    coef = _vinv_coef(torch.sum(w * w, dim=-1))
    Vinv = _eye3_like(W) - 0.5 * W + coef[..., None, None] * (W @ W)
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble 4x4 homogeneous transform(s) from rotation + translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # Built on the device: a constant made from a Python list would be a
    # host->device copy that synchronises the stream on every call.
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def mat_inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid 4x4 transform (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 rigid transform(s) to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def rotate_dirs(T_or_R: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Rotate (..., N, 3) direction vectors by the rotation part of T (4x4 or 3x3)."""
    return dirs @ T_or_R[..., :3, :3].transpose(-1, -2)


def geodesic_angle(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Rotation angle (radians) between two rotation matrices."""
    Rrel = Ra.transpose(-1, -2) @ Rb
    trace = Rrel[..., 0, 0] + Rrel[..., 1, 1] + Rrel[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
