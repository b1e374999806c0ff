"""Intrinsics and depth-deformation self-calibration (Schur complement).

Counterpart of ``badslam_tpu/ba/intrinsics_opt.py`` (OptimizeIntrinsicsCUDA,
kernel_opt_intrinsics.cu, kernel_opt_intrinsics.cc:39-281). Unknowns:

  depth:  x1 = [fx_inv, fy_inv, cx_inv, cy_inv, a]  (5 global) and
          x2 = cfactor per sparsification cell (arrow-head structure), where
          calibrated depth d_cal = 1 / (1/d_raw + cfactor * exp(-a / d_raw))
          (util.cuh:62-79). Solved by the Schur complement over x2.
  color:  [fx, fy, cx, cy] of the descriptor-sampling camera, plain 4x4 GN
          over the photometric residuals; with both, folded into the depth
          system (one shared camera, as in the JAX package).

The system is summed over the keyframes of the stack's mask in batches of
up to ``KEYFRAME_BATCH`` ([C, N] fields); the per-cell sums (B, D, b2, obs)
are ``index_add_`` over the cell ids, which on CUDA tensors adds in no fixed
order (float sums then differ from run to run in the last bits; the counts
are exact). Only the 5x5 (or 4x4) solve runs on the host, in float64, as
the reference requires (kernel_opt_intrinsics.cc:166-168).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from badslam_torch.geometry import se3
from badslam_torch.mapping.association import (
    associate_surfels_with_frame,
    tangent_projections,
)
from badslam_torch.mapping.keyframes import KeyframeStack, keyframe_batches
from badslam_torch.ops import robust
from badslam_torch.ops.interp import bilinear_and_gradient, gather_nearest
from badslam_torch.ops.preprocess import (
    apply_depth_deformation,
    compute_normals,
    compute_radii_and_remove_isolated,
)

A_PRIOR_WEIGHT = 10.0  # weak zero-prior on `a` (kernel_opt_intrinsics.cc:154)


class DepthParams(NamedTuple):
    """Depth-deformation state (DepthParameters analog)."""

    a: torch.Tensor        # [] f32 global deformation parameter
    cfactor: torch.Tensor  # [Hc, Wc] f32 per-sparsification-cell factors


def cfactor_shape(height: int, width: int, cell_size: int) -> Tuple[int, int]:
    """Ceil-div grid, matching (w-1)/cell+1 (kernel_opt_intrinsics.cc:64)."""
    return ((height - 1) // cell_size + 1, (width - 1) // cell_size + 1)


def empty_depth_params(height: int, width: int, cell_size: int,
                       device: torch.device | str) -> DepthParams:
    return DepthParams(
        a=torch.zeros((), dtype=torch.float32, device=device),
        cfactor=torch.zeros(cfactor_shape(height, width, cell_size),
                            dtype=torch.float32, device=device))


def recalibrate_planes(cam, raw_depth: torch.Tensor, a, cfactor,
                       cell_size: int = 4):
    """(depth, nx, ny, radius2), each [K, H, W], re-derived from the raw
    (pre-deformation) depth [K, H, W] with the given camera and deformation,
    as preprocessing derives them."""
    out = []
    for raw in raw_depth:
        cal = apply_depth_deformation(raw, a, cfactor, cell_size)
        d1, nx, ny = compute_normals(cam, cal)
        d2, r2 = compute_radii_and_remove_isolated(cam, d1)
        keep = d2 > 0
        out.append((d2, torch.where(keep, nx, 0.0), torch.where(keep, ny, 0.0), r2))
    return tuple(torch.stack(planes) for planes in zip(*out))


def accumulate_intrinsics_coeffs(smap, cam, kstack: KeyframeStack,
                                 raw_depth: torch.Tensor, params: DepthParams,
                                 baseline_fx: float, cell_size: int,
                                 optimize_depth: bool = True,
                                 optimize_color: bool = True):
    """Accumulate the arrow-head GN system over the masked keyframes and all
    surfels. `raw_depth` is [K, H, W], aligned with kstack.

    Returns (depth system (A [5, 5], b1 [5], B [C, 5], D [C], b2 [C],
    obs [C] int64), color system (H [4, 4], b [4])); each is zero when not
    asked for."""
    hc, wc = params.cfactor.shape
    num_cells = hc * wc
    dtype = smap.pos.dtype
    dev = smap.pos.device

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    A, b1, B, D, b2 = z(5, 5), z(5), z(num_cells, 5), z(num_cells), z(num_cells)
    obs = z(num_cells, dtype=torch.int64)
    Hc, bc = z(4, 4), z(4)
    cf_flat = params.cfactor.reshape(-1)

    for s in keyframe_batches(kstack.mask):
        ftg = se3.inverse(se3.SE3(kstack.q[s], kstack.t[s]))
        a = associate_surfels_with_frame(
            cam, smap.pos, smap.normal, smap.valid, ftg.q, ftg.t,
            kstack.depth[s], kstack.nx[s], kstack.ny[s], baseline_fx)
        ok = a.valid
        inv_stddev = 1.0 / torch.clamp_min(a.stddev, 1e-30)
        pxf = a.px.to(dtype)
        pyf = a.py.to(dtype)
        un_x = cam.fx_inv * pxf + cam.cx_inv
        un_y = cam.fy_inv * pyf + cam.cy_inv
        d_cal = a.pixel_depth

        if optimize_depth:
            cell = torch.where(ok, (a.py // cell_size) * wc + (a.px // cell_size), 0)
            raw_d = gather_nearest(raw_depth[s], a.px, a.py)
            # Not guarded before the exponential: invalid rows are masked
            # after it (okd), as in the JAX package.
            raw_inv = 1.0 / torch.clamp_min(raw_d, 1e-12)
            cf = cf_flat[cell]
            e = torch.exp(-params.a * raw_inv)
            ci = raw_inv + cf * e
            okd = ok & (raw_d > 0) & (torch.abs(ci) > 1e-4)

            dot = a.nlx * un_x + a.nly * un_y + a.nlz
            jac_base = inv_stddev * dot * e / (ci * ci)
            j_cx = inv_stddev * d_cal * a.nlx
            j_cy = inv_stddev * d_cal * a.nly
            J = torch.stack([pxf * j_cx, pyf * j_cy, j_cx, j_cy,
                             cf * raw_inv * jac_base], dim=-1)  # [C, N, 5]
            j_cf = -jac_base
            r = inv_stddev * (a.nlx * (d_cal * un_x - a.lx)
                              + a.nly * (d_cal * un_y - a.ly)
                              + a.nlz * (d_cal - a.lz))
            wgt = torch.where(okd, robust.depth_residual_weight(r), 0.0)

            wJ = J * wgt[..., None]
            A = A + torch.einsum("cni,cnj->ij", wJ, J)
            b1 = b1 + torch.einsum("cni,cn->i", wJ, r)
            flat = cell.reshape(-1)
            B.index_add_(0, flat, (wJ * j_cf[..., None]).reshape(-1, 5))
            D.index_add_(0, flat, (wgt * j_cf * j_cf).reshape(-1))
            b2.index_add_(0, flat, (wgt * r * j_cf).reshape(-1))
            obs.index_add_(0, flat, okd.reshape(-1).to(torch.int64))

        if optimize_color:
            t1x, t1y, t2x, t2y, t_ok = tangent_projections(
                smap.pos, smap.normal, smap.radius2, ftg.q, ftg.t, cam)
            okc = ok & t_ok
            inten = kstack.intensity[s]
            ic, c_dx, c_dy = bilinear_and_gradient(inten, a.pxy_x, a.pxy_y)
            for slot, (tx, ty) in enumerate(((t1x, t1y), (t2x, t2y))):
                ik, t_dx, t_dy = bilinear_and_gradient(inten, tx, ty)
                r = 180.0 * (ik - ic) - smap.desc[:, slot]
                wgt = torch.where(okc, robust.descriptor_residual_weight(r), 0.0)
                gx = 180.0 * (t_dx - c_dx)
                gy = 180.0 * (t_dy - c_dy)
                Jc = torch.stack([gx * un_x, gy * un_y, gx, gy], dim=-1)
                wJ = Jc * wgt[..., None]
                Hc = Hc + torch.einsum("cni,cnj->ij", wJ, Jc)
                bc = bc + torch.einsum("cni,cn->i", wJ, r)

    return (A, b1, B, D, b2, obs), (Hc, bc)


def schur_reduce(depth_sys):
    """(A, b1, B, D, b2, obs) -> the Schur-reduced (A', b1') and the
    back-substitution terms (D^-1 B, D^-1 b2, good cells, obs)."""
    A, b1, B, D, b2, obs = depth_sys
    good = D > 1e-12
    D_inv = torch.where(good, 1.0 / torch.clamp_min(D, 1e-30), 0.0)
    DiB = B * D_inv[:, None]
    A_r = A - torch.einsum("ci,cj->ij", DiB, B)
    Dib2 = D_inv * b2
    b1_r = b1 - torch.einsum("ci,c->i", B, Dib2)
    return A_r, b1_r, DiB, Dib2, good, obs


def _f64(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.array(x, np.float64)


def solve_depth_intrinsics(A_r, b1_r, a) -> np.ndarray:
    """Host float64 5x5 solve with the weak a-prior (must be float64:
    kernel_opt_intrinsics.cc:166-168)."""
    A = _f64(A_r)
    b = _f64(b1_r)
    A[4, 4] += A_PRIOR_WEIGHT * A_PRIOR_WEIGHT
    b[4] += A_PRIOR_WEIGHT * A_PRIOR_WEIGHT * float(a)
    try:
        return np.linalg.solve(A, b).astype(np.float32)
    except np.linalg.LinAlgError:
        return np.zeros(5, np.float32)


def backsubstitute_cfactor(params: DepthParams, x1, DiB, Dib2, good, obs) -> DepthParams:
    """x2 = D^-1 b2 - D^-1 B x1; cfactor -= x2; unobserved cells -> 0."""
    x1 = torch.as_tensor(np.asarray(x1, np.float32), device=DiB.device)
    offset = torch.where(good, Dib2 - DiB @ x1, 0.0)
    cf = params.cfactor.reshape(-1) - offset
    cf = torch.where(obs > 0, cf, 0.0)
    return DepthParams(a=params.a - x1[4], cfactor=cf.reshape(params.cfactor.shape))


def updated_depth_camera(cam, x1):
    """Apply the inverse-parametrization update on the host (float64) and
    convert back to corner-convention fx..cy (kernel_opt_intrinsics.cc:184-196)."""
    fx_inv = float(cam.fx_inv) - float(x1[0])
    fy_inv = float(cam.fy_inv) - float(x1[1])
    cx_inv = float(cam.cx_inv) - float(x1[2])
    cy_inv = float(cam.cy_inv) - float(x1[3])
    fx = 1.0 / fx_inv
    fy = 1.0 / fy_inv
    return cam.with_intrinsics(fx=fx, fy=fy, cx=-(fx * cx_inv) + 0.5,
                               cy=-(fy * cy_inv) + 0.5)


def _color_to_inverse_param_T(cam) -> np.ndarray:
    """Constant chain-rule matrix T = d[fx, fy, cx, cy] / d[fx_inv, .., cy_inv, a]:
    with fx = 1/fx_inv and cx = -(fx * cx_inv) + 0.5 the photometric 4x4
    system folds exactly into the depth 5x5 one as A += T^T H T,
    b += T^T b_c."""
    fx, fy = float(cam.fx), float(cam.fy)
    cx_inv, cy_inv = float(cam.cx_inv), float(cam.cy_inv)
    T = np.zeros((4, 5), np.float64)
    T[0, 0] = -fx * fx
    T[1, 1] = -fy * fy
    T[2, 0] = cx_inv * fx * fx
    T[2, 2] = -fx
    T[3, 1] = cy_inv * fy * fy
    T[3, 3] = -fy
    return T


def solve_color_intrinsics(color_sys) -> np.ndarray:
    H, b = color_sys
    try:
        return np.linalg.solve(_f64(H), _f64(b)).astype(np.float32)
    except np.linalg.LinAlgError:
        return np.zeros(4, np.float32)


def updated_color_camera(cam, x):
    return cam.with_intrinsics(
        fx=float(cam.fx) - float(x[0]), fy=float(cam.fy) - float(x[1]),
        cx=float(cam.cx) - float(x[2]), cy=float(cam.cy) - float(x[3]))


def optimize_intrinsics(smap, cam, kstack: KeyframeStack, raw_depth: torch.Tensor,
                        params: DepthParams, baseline_fx: float, cell_size: int,
                        optimize_depth: bool = True,
                        optimize_color: bool = False):
    """One intrinsics GN step. Returns (new camera, new depth parameters).

    With both systems the photometric one folds into the Schur-reduced
    depth one through the exact change of parametrization
    (`_color_to_inverse_param_T`): one update of the one shared camera, as
    in the JAX package (color is resampled into the depth camera at
    preprocessing, so the reference's separate color camera collapses onto
    it)."""
    depth_sys, color_sys = accumulate_intrinsics_coeffs(
        smap, cam, kstack, raw_depth, params, baseline_fx, cell_size,
        optimize_depth=optimize_depth, optimize_color=optimize_color)
    new_cam = cam
    if optimize_depth:
        A_r, b1_r, DiB, Dib2, good, obs = schur_reduce(depth_sys)
        if optimize_color:
            T = _color_to_inverse_param_T(cam)
            A_r = _f64(A_r) + T.T @ _f64(color_sys[0]) @ T
            b1_r = _f64(b1_r) + T.T @ _f64(color_sys[1])
        x1 = solve_depth_intrinsics(A_r, b1_r, params.a)
        if np.all(np.isfinite(x1)):
            params = backsubstitute_cfactor(params, x1, DiB, Dib2, good, obs)
            new_cam = updated_depth_camera(new_cam, x1)
    elif optimize_color:
        x = solve_color_intrinsics(color_sys)
        if np.all(np.isfinite(x)):
            new_cam = updated_color_camera(new_cam, x)
    return new_cam, params
