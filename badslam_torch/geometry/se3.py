"""SE(3) Lie-group math on quaternion + translation pairs (PyTorch).

Counterpart of ``badslam_tpu/geometry/se3.py``. A pose is a pair ``(q, t)``
where ``q`` is a unit quaternion stored as ``[w, x, y, z]`` with shape
``[..., 4]`` and ``t`` a translation ``[..., 3]``. Tangent vectors are
ordered ``[translation(3), rotation(3)]``. All functions broadcast over
leading batch dimensions and keep the device and dtype of their inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class SE3(NamedTuple):
    """Rigid transform; acts on points as ``R(q) @ p + t``."""

    q: torch.Tensor  # [..., 4] unit quaternion, wxyz
    t: torch.Tensor  # [..., 3]


def identity(device: torch.device | str, batch_shape: Tuple[int, ...] = (),
             dtype: torch.dtype = torch.float32) -> SE3:
    q = torch.zeros(batch_shape + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return SE3(q, torch.zeros(batch_shape + (3,), dtype=dtype, device=device))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    # Negation, not a product with a constant tensor: building that constant
    # is a host-to-device copy on every call.
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    # v' = v + 2*qv x (qv x v + qw*v)
    uv = _cross(qv, v)
    uuv = _cross(qv, uv + qw * v)
    return v + 2.0 * uuv


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def slerp(qa: torch.Tensor, qb: torch.Tensor, f) -> torch.Tensor:
    """Spherical interpolation between unit quaternions (Eigen's
    Quaternion::slerp semantics, as in the JAX package). `f` broadcasts
    against [..., 4]."""
    d = torch.sum(qa * qb, dim=-1, keepdim=True)
    qb = torch.where(d < 0, -qb, qb)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    close = d > 0.9995
    safe_sin = torch.where(close, 1.0, torch.sin(theta))
    wa = torch.where(close, 1.0 - f, torch.sin((1.0 - f) * theta) / safe_sin)
    wb = torch.where(close, f, torch.sin(f * theta) / safe_sin)
    return quat_normalize(wa * qa + wb * qb)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [..., 3, 3] rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] quaternion, wxyz. Branch-free (Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw0 = torch.sqrt(torch.clamp_min(1.0 + tr, 0.0)) / 2
    q0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0 + 1e-30), (m02 - m20) / (4 * qw0 + 1e-30),
         (m10 - m01) / (4 * qw0 + 1e-30)], dim=-1)

    qx1 = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, 1e-30)) / 2
    q1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
         (m02 + m20) / (4 * qx1)], dim=-1)

    qy2 = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, 1e-30)) / 2
    q2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
         (m12 + m21) / (4 * qy2)], dim=-1)

    qz3 = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, 1e-30)) / 2
    q3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
         (m12 + m21) / (4 * qz3), qz3], dim=-1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return quat_normalize(q)


def mul(a: SE3, b: SE3) -> SE3:
    """Compose: (a*b)(p) = a(b(p))."""
    return SE3(quat_normalize(quat_mul(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def inverse(a: SE3) -> SE3:
    qi = quat_conj(a.q)
    return SE3(qi, -quat_rotate(qi, a.t))


def _so3_exp(omega: torch.Tensor):
    """Returns (quaternion, theta_sq, theta). Taylor-safe near zero."""
    theta_sq = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta_sq)
    half = 0.5 * theta
    small = theta_sq < 1e-8
    # sin(x/2)/x and cos(x/2)
    sinc_half = torch.where(
        small, 0.5 - theta_sq / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(theta), theta))
    cos_half = torch.cos(half)
    q = torch.cat([cos_half[..., None], sinc_half[..., None] * omega], dim=-1)
    return quat_normalize(q), theta_sq, theta


def exp(xi: torch.Tensor) -> SE3:
    """se(3) exponential. xi = [..., 6] = [translation v, rotation w]."""
    v = xi[..., 0:3]
    omega = xi[..., 3:6]
    q, theta_sq, theta = _so3_exp(omega)

    small = theta_sq < 1e-8
    one = torch.ones_like(theta)
    safe_theta_sq = torch.where(small, one, theta_sq)
    safe_theta = torch.where(small, one, theta)
    # V = I + (1-cos)/t^2 W + (t-sin)/t^3 W^2
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / safe_theta_sq)
    b = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / (safe_theta_sq * safe_theta),
    )
    wxv = _cross(omega, v)
    wxwxv = _cross(omega, wxv)
    t = v + a[..., None] * wxv + b[..., None] * wxwxv
    return SE3(q, t)


def log(T: SE3) -> torch.Tensor:
    """SE(3) log map -> [..., 6] = [v, w]."""
    q = T.q
    qw = q[..., 0]
    qv = q[..., 1:4]
    n = torch.linalg.vector_norm(qv, dim=-1)
    # Handle q ~ -q ambiguity: use atan2 of (n, qw); theta in [0, pi]
    theta = 2.0 * torch.atan2(n, qw)
    # wrap to [-pi, pi]
    theta = torch.where(theta > math.pi, theta - 2 * math.pi, theta)
    small = n < 1e-8
    one = torch.ones_like(n)
    scale = torch.where(
        small, 2.0 / torch.where(torch.abs(qw) < 1e-12, one, qw),
        theta / torch.where(small, one, n))
    omega = scale[..., None] * qv

    theta_sq = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta_sq)
    small = theta_sq < 1e-8
    one = torch.ones_like(theta)
    safe_theta_sq = torch.where(small, one, theta_sq)
    safe_theta = torch.where(small, one, theta)
    half = 0.5 * safe_theta
    # V^{-1} = I - 1/2 W + c W^2 with c = (1 - theta*cos(half)/(2 sin(half)))/theta^2
    c = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - safe_theta * torch.cos(half) / (2.0 * torch.sin(half)))
        / safe_theta_sq,
    )
    t = T.t
    wxt = _cross(omega, t)
    wxwxt = _cross(omega, wxt)
    v = t - 0.5 * wxt + c[..., None] * wxwxt
    return torch.cat([v, omega], dim=-1)
