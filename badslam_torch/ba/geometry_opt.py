"""Surfel geometry optimization: activation, normals, position, descriptors.

Counterpart of ``badslam_tpu/ba/geometry_opt.py``
(OptimizeGeometryIterationCUDA, kernel_opt_geometry.cu,
kernel_opt_geometry.cc:80-201). Two sub-steps per BA iteration:

  (a) normals: average the observing keyframes' measurement normals
      (rotated to world) over all associations;
  (b) position along the normal, jointly with the 2 descriptor components
      when photometric residuals are on: a per-surfel 3x3 (or 1x1)
      Gauss-Newton system summed over keyframes, then a closed-form
      Cholesky solve per surfel.

Keyframes are taken in batches of up to ``KEYFRAME_BATCH`` ([C, N]
fields); only the keyframes of the operation's mask are visited, which
changes nothing but the order of the float sums (masked-out keyframes
contribute exact zeros in the JAX package). Averaged normals are
re-normalized to unit length, as there.
"""

from __future__ import annotations

import torch

from badslam_torch.geometry import se3
from badslam_torch.geometry.linalg import rotate3
from badslam_torch.mapping.association import (
    associate_surfels_with_frame,
    tangent_projections,
)
from badslam_torch.mapping.keyframes import KeyframeStack, keyframe_batches
from badslam_torch.ops import robust
from badslam_torch.ops.interp import bilinear_and_gradient, gather_nearest
from badslam_torch.ops.preprocess import normal_z


def _assoc_batch(cam, pos, normal, mask, q, t, depth, nx, ny, baseline_fx):
    """Associate all surfels with C keyframes (global_T_frame poses
    [C, 4]/[C, 3], planes [C, H, W]) at once: [C, N] fields."""
    ftg = se3.inverse(se3.SE3(q, t))
    return ftg, associate_surfels_with_frame(
        cam, pos, normal, mask, ftg.q, ftg.t, depth, nx, ny, baseline_fx)


def _measured_normals(q, nx, ny, a):
    """[C, N, 3] world-space measurement normals at the associated pixels."""
    mnx = gather_nearest(nx, a.px, a.py)
    mny = gather_nearest(ny, a.px, a.py)
    n_local = torch.stack([mnx, mny, normal_z(mnx, mny)], dim=-1)
    return rotate3(se3.quat_to_matrix(q), n_local)


def _renormalized(normal, nsum, cnt, use):
    norm = torch.linalg.vector_norm(nsum, dim=-1, keepdim=True)
    return torch.where((use & (cnt >= 1))[:, None] & (norm > 1e-12),
                       nsum / torch.clamp_min(norm, 1e-12), normal)


# ---------------------------------------------------------------------------
# Activation + normals from one association pass
# ---------------------------------------------------------------------------


def update_activation_and_normals(smap, cam, kstack: KeyframeStack,
                                  active_strict: torch.Tensor,
                                  participating: torch.Tensor,
                                  baseline_fx: float,
                                  update_normals: bool = True):
    """Surfel activation (UpdateSurfelActivationCUDA: active iff associated
    with an ACTIVE keyframe) and normal averaging over the participating
    keyframes, from one association pass. Associations use the validity
    mask alone, which is exact: a surfel's association does not depend on
    its active flag."""
    n = smap.capacity
    dev = smap.pos.device
    act = torch.zeros(n, dtype=torch.bool, device=dev)
    nsum = torch.zeros((n, 3), dtype=smap.normal.dtype, device=dev)
    cnt = torch.zeros(n, dtype=torch.int64, device=dev)
    visit = participating | active_strict if update_normals else active_strict
    for s in keyframe_batches(visit):
        _, a = _assoc_batch(cam, smap.pos, smap.normal, smap.valid,
                            kstack.q[s], kstack.t[s], kstack.depth[s],
                            kstack.nx[s], kstack.ny[s], baseline_fx)
        act = act | torch.any(a.valid & active_strict[s][:, None], dim=0)
        if update_normals:
            hit = a.valid & participating[s][:, None]
            gn = _measured_normals(kstack.q[s], kstack.nx[s], kstack.ny[s], a)
            nsum = nsum + torch.where(hit[..., None], gn, 0.0).sum(dim=0)
            cnt = cnt + hit.sum(dim=0)
    act = act & smap.valid
    smap = smap._replace(active=act)
    if not update_normals:
        return smap
    return smap._replace(normal=_renormalized(smap.normal, nsum, cnt, act))


def update_surfel_normals(smap, cam, kstack: KeyframeStack, baseline_fx: float):
    """Step (a) alone: re-estimate the active surfels' normals from the
    keyframes of kstack.mask."""
    n = smap.capacity
    dev = smap.pos.device
    nsum = torch.zeros((n, 3), dtype=smap.normal.dtype, device=dev)
    cnt = torch.zeros(n, dtype=torch.int64, device=dev)
    for s in keyframe_batches(kstack.mask):
        _, a = _assoc_batch(cam, smap.pos, smap.normal, smap.valid & smap.active,
                            kstack.q[s], kstack.t[s], kstack.depth[s],
                            kstack.nx[s], kstack.ny[s], baseline_fx)
        gn = _measured_normals(kstack.q[s], kstack.nx[s], kstack.ny[s], a)
        nsum = nsum + torch.where(a.valid[..., None], gn, 0.0).sum(dim=0)
        cnt = cnt + a.valid.sum(dim=0)
    return smap._replace(normal=_renormalized(smap.normal, nsum, cnt, smap.valid))


# ---------------------------------------------------------------------------
# Step (b): position (+ descriptors)
# ---------------------------------------------------------------------------


def _depth_residual(cam, a, dtype):
    """(r, J, inverse sigma) of the point-to-plane residual against the
    position along the normal."""
    inv_stddev = 1.0 / torch.clamp_min(a.stddev, 1e-30)
    un_x = cam.fx_inv * a.px.to(dtype) + cam.cx_inv
    un_y = cam.fy_inv * a.py.to(dtype) + cam.cy_inv
    r = inv_stddev * (a.nlx * (a.pixel_depth * un_x - a.lx)
                      + a.nly * (a.pixel_depth * un_y - a.ly)
                      + a.nlz * (a.pixel_depth - a.lz))
    return r, -inv_stddev


def _position_step(smap, cam, kstack: KeyframeStack, baseline_fx: float,
                   use_depth: bool, use_descriptor: bool):
    """Sum the per-surfel position (+descriptor) Gauss-Newton system over
    the masked keyframes and solve it."""
    n = smap.capacity
    dev = smap.pos.device
    dtype = smap.pos.dtype
    upd_mask = smap.valid & smap.active
    batches = keyframe_batches(kstack.mask)

    def z():
        return torch.zeros(n, dtype=dtype, device=dev)

    if not use_descriptor:
        # 1-D position along the normal from depth residuals alone.
        H, b = z(), z()
        for s in batches:
            _, a = _assoc_batch(cam, smap.pos, smap.normal, upd_mask,
                                kstack.q[s], kstack.t[s], kstack.depth[s],
                                kstack.nx[s], kstack.ny[s], baseline_fx)
            r, J = _depth_residual(cam, a, dtype)
            w = torch.where(a.valid, robust.depth_residual_weight(r), 0.0)
            H = H + torch.sum(w * J * J, dim=0)
            b = b + torch.sum(w * r * J, dim=0)
        upd = upd_mask & (H > 1e-6)
        step = torch.where(upd, -b / torch.clamp_min(H, 1e-6), 0.0)
        return smap._replace(pos=smap.pos + step[:, None] * smap.normal)

    # Position + 2 descriptor components jointly (3x3 per surfel).
    H00, H01, H02, H11, H12, H22, b0, b1, b2 = (z() for _ in range(9))
    for s in batches:
        ftg, a = _assoc_batch(cam, smap.pos, smap.normal, upd_mask,
                              kstack.q[s], kstack.t[s], kstack.depth[s],
                              kstack.nx[s], kstack.ny[s], baseline_fx)
        hit = a.valid
        if use_depth:
            r, Jd = _depth_residual(cam, a, dtype)
            w = torch.where(hit, robust.depth_residual_weight(r), 0.0)
            H00 = H00 + torch.sum(w * Jd * Jd, dim=0)
            b0 = b0 + torch.sum(w * r * Jd, dim=0)

        # Descriptor residuals at the tangent points.
        inten = kstack.intensity[s]
        t1x, t1y, t2x, t2y, t_ok = tangent_projections(
            smap.pos, smap.normal, smap.radius2, ftg.q, ftg.t, cam)
        dhit = hit & t_ok
        ic, c_dx, c_dy = bilinear_and_gradient(inten, a.pxy_x, a.pxy_y)
        i1, t1_dx, t1_dy = bilinear_and_gradient(inten, t1x, t1y)
        i2, t2_dx, t2_dy = bilinear_and_gradient(inten, t2x, t2y)
        r1 = torch.where(dhit, 180.0 * (i1 - ic) - smap.desc[:, 0], 0.0)
        r2 = torch.where(dhit, 180.0 * (i2 - ic) - smap.desc[:, 1], 0.0)
        w1 = torch.where(dhit, robust.descriptor_residual_weight(r1), 0.0)
        w2 = torch.where(dhit, robust.descriptor_residual_weight(r2), 0.0)

        # d residual / d (position along the normal), fx/fy folded into the
        # terms (kernel_opt_geometry.cu:188-196).
        gx1 = 180.0 * (t1_dx - c_dx)
        gy1 = 180.0 * (t1_dy - c_dy)
        gx2 = 180.0 * (t2_dx - c_dx)
        gy2 = 180.0 * (t2_dy - c_dy)
        safe_z = torch.where(dhit, a.lz, 1.0)
        term1 = -cam.fx * (a.nlx * a.lz - a.nlz * a.lx)
        term2 = -cam.fy * (a.nly * a.lz - a.nlz * a.ly)
        term3 = 1.0 / (safe_z * safe_z)
        jp1 = -(gx1 * term1 + gy1 * term2) * term3
        jp2 = -(gx2 * term1 + gy2 * term2) * term3
        jd = -1.0  # d residual / d descriptor

        H00 = H00 + torch.sum(w1 * jp1 * jp1 + w2 * jp2 * jp2, dim=0)
        H01 = H01 + torch.sum(w1 * jp1 * jd, dim=0)
        H02 = H02 + torch.sum(w2 * jp2 * jd, dim=0)
        H11 = H11 + torch.sum(w1 * jd * jd, dim=0)
        H22 = H22 + torch.sum(w2 * jd * jd, dim=0)
        b0 = b0 + torch.sum(w1 * r1 * jp1 + w2 * r2 * jp2, dim=0)
        b1 = b1 + torch.sum(w1 * r1 * jd, dim=0)
        b2 = b2 + torch.sum(w2 * r2 * jd, dim=0)

    # Vectorized 3x3 Cholesky solve (kernel_opt_geometry.cu:273-340).
    eps = 1e-6
    H00 = H00 + eps
    H11 = H11 + eps
    H22 = H22 + eps
    L00 = torch.sqrt(H00)
    L01 = H01 / L00
    L11 = torch.sqrt(torch.clamp_min(H11 - L01 * L01, 1e-12))
    L02 = H02 / L00
    L12 = (H12 - L02 * L01) / L11
    L22 = torch.sqrt(torch.clamp_min(H22 - L02 * L02 - L12 * L12, 1e-12))

    y0 = b0 / L00
    y1 = (b1 - L01 * y0) / L11
    y2 = (b2 - L02 * y0 - L12 * y1) / L22
    x2 = y2 / L22
    x1 = (y1 - L12 * x2) / L11
    x0 = (y0 - L02 * x2 - L01 * x1) / L00

    fin = upd_mask & torch.isfinite(x0) & torch.isfinite(x1) & torch.isfinite(x2)
    x0 = torch.where(fin, x0, 0.0)
    x1 = torch.where(fin, x1, 0.0)
    x2 = torch.where(fin, x2, 0.0)
    return smap._replace(
        pos=smap.pos - x0[:, None] * smap.normal,
        desc=torch.clamp(smap.desc - torch.stack([x1, x2], dim=-1), -180.0, 180.0))


def optimize_geometry_iteration(smap, cam, kstack: KeyframeStack,
                                baseline_fx: float = 40.0,
                                use_depth: bool = True,
                                use_descriptor: bool = True):
    """One full geometry step: normals, then position (+descriptors)."""
    smap = update_surfel_normals(smap, cam, kstack, baseline_fx)
    return _position_step(smap, cam, kstack, baseline_fx, use_depth,
                           use_descriptor)
