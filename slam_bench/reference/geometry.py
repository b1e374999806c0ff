"""Rigid transforms, the pinhole camera and the 6x6 solve of the reference.

A frozen copy of the port's plain versions (``geometry/se3.py``,
``geometry/linalg.py``, ``geometry/camera.py``'s pinhole) as they stood
when the benchmark was defined, so that a later change to the program
cannot change its yardstick. It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Pinhole intrinsics in the pixel-corner convention: pixel (x, y)
    covers [x, x+1) x [y, y+1); integer indices unproject at their centre,
    nx(px) = (px + 0.5 - cx) / fx."""
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def pyramid_level(self, level: int) -> "PinholeCamera":
        cam = self
        for _ in range(level):
            cam = PinholeCamera(fx=cam.fx * 0.5, fy=cam.fy * 0.5, cx=cam.cx * 0.5,
                                cy=cam.cy * 0.5, width=cam.width // 2,
                                height=cam.height // 2)
        return cam

    @property
    def fx_inv(self) -> float:
        return 1.0 / self.fx

    @property
    def fy_inv(self) -> float:
        return 1.0 / self.fy

    @property
    def cx_inv(self) -> float:
        return -(self.cx - 0.5) / self.fx

    @property
    def cy_inv(self) -> float:
        return -(self.cy - 0.5) / self.fy


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



def solve_psd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for small symmetric positive-definite H (f32-exact).

    Unrolled Cholesky with every pivot clamped to at least 1e-30, as in the
    JAX package: a singular or indefinite H gives a finite (possibly huge)
    step instead of raising, which the caller's finiteness guard then
    judges. ``torch.linalg.cholesky`` would raise or return NaN instead.
    """
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp_min(s, 1e-30))
        for i in range(j + 1, n):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)

