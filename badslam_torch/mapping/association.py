"""Surfel <-> keyframe-pixel association, vectorized over all surfels.

Counterpart of ``badslam_tpu/mapping/association.py`` (IsAssociatedWithPixel
/ SurfelProjectsToAssociatedPixel, surfel_projection_nvcc_only.cuh:46-230):
project every surfel into a frame, gather the pixel's measurements (through
``gather_nearest``, i.e. K2 on the card), and apply the association gates:
depth gap against the propagated stereo sigma, camera-facing, normal
compatibility.

Both functions also take a batch of frames: frame poses [C, 4] / [C, 3]
with planes [C, H, W] give [C, N] fields (the JAX package's vmap over
keyframes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from badslam_torch.geometry import se3
from badslam_torch.geometry.linalg import rotate3, transform3
from badslam_torch.ops import robust
from badslam_torch.ops.interp import gather_nearest
from badslam_torch.ops.preprocess import normal_z


class Association(NamedTuple):
    """Per-surfel association against one frame (or a batch of frames)."""

    valid: torch.Tensor        # associated with the pixel it projects to
    projects: torch.Tensor     # projects into the image onto valid depth
    free_space_violation: torch.Tensor  # pixel depth far behind the surfel
    px: torch.Tensor           # int64 pixel column (clamped)
    py: torch.Tensor           # int64 pixel row (clamped)
    pxy_x: torch.Tensor        # float corner-convention projection x
    pxy_y: torch.Tensor
    lx: torch.Tensor           # surfel position in frame coordinates
    ly: torch.Tensor
    lz: torch.Tensor
    nlx: torch.Tensor          # surfel normal in frame coordinates
    nly: torch.Tensor
    nlz: torch.Tensor
    pixel_depth: torch.Tensor  # measured depth at (py, px)
    stddev: torch.Tensor       # propagated depth-residual sigma


def associate_surfels_with_frame(
    cam,
    positions: torch.Tensor,     # [N, 3] global
    normals: torch.Tensor,       # [N, 3] global
    surfel_mask: torch.Tensor,   # [N] bool
    frame_q: torch.Tensor,       # [4] or [C, 4] frame_T_global rotation
    frame_t: torch.Tensor,       # [3] or [C, 3]
    depth: torch.Tensor,         # [H, W] or [C, H, W]
    f_nx: torch.Tensor,
    f_ny: torch.Tensor,
    baseline_fx: float,
    depth_tukey_param: float = robust.DEPTH_TUKEY_PARAM,
) -> Association:
    h, w = depth.shape[-2:]
    R = se3.quat_to_matrix(frame_q)
    lx, ly, lz = transform3(R, frame_t, positions).unbind(-1)
    proj = surfel_mask & (lz > 0)

    safe_z = torch.where(proj, lz, 1.0)
    pxy_x = cam.fx * lx / safe_z + cam.cx
    pxy_y = cam.fy * ly / safe_z + cam.cy
    pxf = torch.floor(pxy_x)
    pyf = torch.floor(pxy_y)
    proj = (proj & (pxy_x >= 0) & (pxy_y >= 0) & (pxf < w) & (pyf < h)
            & (pxf >= 0) & (pyf >= 0))
    # Clamped as floats, then converted: the same integers as the JAX
    # package's convert-then-clip for every finite projection.
    px = torch.clamp(pxf, 0, w - 1).to(torch.int64)
    py = torch.clamp(pyf, 0, h - 1).to(torch.int64)

    d_pix = gather_nearest(depth, px, py)
    projects = proj & (d_pix > 0)

    nlx, nly, nlz = rotate3(R, normals).unbind(-1)
    un_x = cam.fx_inv * px.to(positions.dtype) + cam.cx_inv
    un_y = cam.fy_inv * py.to(positions.dtype) + cam.cy_inv
    stddev = (robust.DEPTH_UNCERTAINTY_EMPIRICAL_FACTOR
              * torch.abs(nlx * un_x + nly * un_y + nlz)
              * (d_pix * d_pix)) / baseline_fx

    gap = d_pix - lz
    threshold = depth_tukey_param * stddev
    fsv = projects & (gap > threshold)
    depth_ok = projects & (torch.abs(gap) <= threshold)

    facing = (lx * nlx + ly * nly + lz * nlz) <= 0

    m_nx = gather_nearest(f_nx, px, py)
    m_ny = gather_nearest(f_ny, px, py)
    m_nz = normal_z(m_nx, m_ny)
    normal_ok = (nlx * m_nx + nly * m_ny + nlz * m_nz
                 ) >= robust.COS_NORMAL_COMPATIBILITY_THRESHOLD

    return Association(
        valid=depth_ok & facing & normal_ok,
        projects=projects,
        free_space_violation=fsv,
        px=px, py=py, pxy_x=pxy_x, pxy_y=pxy_y,
        lx=lx, ly=ly, lz=lz, nlx=nlx, nly=nly, nlz=nlz,
        pixel_depth=d_pix, stddev=stddev,
    )


def tangent_projections(
    positions: torch.Tensor,   # [N, 3] global
    normals: torch.Tensor,     # [N, 3] global
    radius2: torch.Tensor,     # [N]
    frame_q: torch.Tensor,     # [4] or [C, 4] frame_T_global
    frame_t: torch.Tensor,
    cam,
):
    """Project two fixed tangent points on each surfel's border
    (ComputeTangentProjections, cost_function.cuh:113-135): t1 = n x (ey if
    |nx| > 0.9 else ex), t2 = n x t1, both scaled to 2 * radius. Returns
    (t1_px, t1_py, t2_px, t2_py, both-in-front mask)."""
    k_tangent_scaling = 2.0
    n = normals
    pick_ey = (torch.abs(n[..., 0]) > 0.9)[..., None]
    ex = n.new_zeros(3)
    ex[0] = 1.0
    ey = n.new_zeros(3)
    ey[1] = 1.0
    ref = torch.where(pick_ey, ey, ex)
    t1 = torch.linalg.cross(n, ref, dim=-1)
    t1 = t1 * (k_tangent_scaling * torch.sqrt(
        radius2 / torch.clamp_min(torch.sum(t1 * t1, dim=-1), 1e-12)))[..., None]
    t2 = torch.linalg.cross(n, t1, dim=-1)
    t2 = t2 * (k_tangent_scaling * torch.sqrt(
        radius2 / torch.clamp_min(torch.sum(t2 * t2, dim=-1), 1e-12)))[..., None]

    R = se3.quat_to_matrix(frame_q)
    p1 = transform3(R, frame_t, positions + t1)
    p2 = transform3(R, frame_t, positions + t2)
    z1, z2 = p1[..., 2], p2[..., 2]
    ok = (z1 > 0) & (z2 > 0)
    s1 = torch.where(z1 > 0, z1, 1.0)
    s2 = torch.where(z2 > 0, z2, 1.0)
    return (cam.fx * p1[..., 0] / s1 + cam.cx, cam.fy * p1[..., 1] / s1 + cam.cy,
            cam.fx * p2[..., 0] / s2 + cam.cx, cam.fy * p2[..., 1] / s2 + cam.cy,
            ok)
