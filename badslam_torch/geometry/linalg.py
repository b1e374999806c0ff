"""Small fixed-size linear algebra helpers (PyTorch).

Counterpart of ``badslam_tpu/geometry/linalg.py``.
"""

from __future__ import annotations

import torch


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


def rotate3(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotation(s) R [..., 3, 3] applied to vectors v [..., N, 3], written
    out per component as in the JAX package (no matmul, so no TF32). The
    leading dimensions of R broadcast against those of v before N, so one
    [3, 3] rotates any [..., 3] stack and [C, 3, 3] rotates [N, 3] into
    [C, N, 3]."""
    x, y, z = v.unbind(-1)
    r = R[..., None, :, :]
    return torch.stack([
        r[..., 0, 0] * x + r[..., 0, 1] * y + r[..., 0, 2] * z,
        r[..., 1, 0] * x + r[..., 1, 1] * y + r[..., 1, 2] * z,
        r[..., 2, 0] * x + r[..., 2, 1] * y + r[..., 2, 2] * z,
    ], dim=-1)


def transform3(R: torch.Tensor, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R v + t, with t [..., 3] batched as R."""
    return rotate3(R, v) + t[..., None, :]
