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

Keyframes are taken in fixed blocks of ``KEYFRAME_BATCH`` slots
(``static_blocks``) with the operation's mask carried along: a keyframe
outside the mask contributes exact zeros, as in the JAX package's fixed
chunks, and no pass reads the mask back to the host. Averaged normals are
re-normalized to unit length, as there.

Each pass is an accumulation per block (``*_chunk``) into a per-row carry
and a per-row finish, dispatched by the map's device: on a CUDA tensor
they launch H3 (``csrc/geometry_coeffs.cu`` through ``ops.kernels``: one
thread per live surfel row loops over the block's slots, with no [C, N]
field in memory; the carry is added into in place), on a CPU tensor they
run the plain chain (``*_plain``: [C, N] fields over every row), which the
``*_plain`` passes also run on any device.
"""

from __future__ import annotations

import torch

from badslam_torch.geometry import se3
from badslam_torch.geometry.linalg import rotate3
from badslam_torch.mapping.association import (
    associate_surfels_with_frame,
    hits,
    tangent_projections,
)
from badslam_torch.mapping.keyframes import KeyframeStack, static_blocks
from badslam_torch.ops import kernels, robust
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


def _on_card(smap) -> bool:
    """Whether a pass over `smap` launches H3 (a CUDA map) or runs the
    plain chain (a CPU map); raises on any other device."""
    if smap.pos.is_cuda:
        return True
    if smap.pos.device.type != "cpu":
        raise ValueError(f"no geometry pass for device {smap.pos.device}")
    return False


def _c(x):
    return None if x is None else x.contiguous()


def _renormalized(normal, nsum, cnt, use):
    norm = torch.linalg.vector_norm(nsum, dim=-1, keepdim=True)
    return torch.where((use & (cnt >= 1))[:, None] & (norm > 1e-12),
                       nsum / torch.clamp_min(norm, 1e-12), normal)


# ---------------------------------------------------------------------------
# Activation + normals from one association pass
# ---------------------------------------------------------------------------
#
# Each stage is a per-batch accumulation (`*_chunk`, over a KeyframeStack
# of up to KEYFRAME_BATCH keyframes) and a per-surfel finish, as in the JAX
# package (_normals_chunk/_normals_finish, _pos1d_chunk, _pos3d_chunk): the
# multi-device path (parallel/streamed.py) feeds the same bodies batches
# whose planes come from the shard that holds them.


def _act_normals_init(smap):
    n = smap.capacity
    dev = smap.pos.device
    return (torch.zeros(n, dtype=torch.bool, device=dev),
            torch.zeros((n, 3), dtype=smap.normal.dtype, device=dev),
            torch.zeros(n, dtype=torch.int64, device=dev))


def _act_normals_chunk(carry, b: KeyframeStack, active_strict, participating,
                       smap, cam, baseline_fx, update_normals):
    """One batch of keyframes `b` with their strictly-active and
    participating flags: carry = (active, normal sum, observation count)."""
    if not _on_card(smap):
        return _act_normals_chunk_plain(carry, b, active_strict, participating,
                                        smap, cam, baseline_fx, update_normals)
    act, nsum, cnt = carry
    kernels.geometry_normals_cuda(
        *(_c(x) for x in (smap.pos, smap.normal, smap.valid, smap.active, b.q, b.t,
                          b.depth, b.nx, b.ny)),
        cam, baseline_fx, (act, nsum, cnt) if update_normals else (act, None, None),
        act_mask=_c(active_strict), normal_mask=_c(participating))
    return carry


def _act_normals_chunk_plain(carry, b: KeyframeStack, active_strict, participating,
                             smap, cam, baseline_fx, update_normals):
    act, nsum, cnt = carry
    _, a = _assoc_batch(cam, smap.pos, smap.normal, smap.valid, b.q, b.t,
                        b.depth, b.nx, b.ny, baseline_fx)
    act = act | torch.any(a.valid & active_strict[:, None], dim=0)
    if update_normals:
        hit = a.valid & participating[:, None]
        gn = _measured_normals(b.q, b.nx, b.ny, a)
        nsum = nsum + torch.where(hit[..., None], gn, 0.0).sum(dim=0)
        cnt = cnt + hit.sum(dim=0)
    return act, nsum, cnt


def _act_normals_finish(smap, carry, update_normals):
    if not _on_card(smap):
        return _act_normals_finish_plain(smap, carry, update_normals)
    # H3 marks valid rows alone: the carry's flags are act & valid.
    act, nsum, cnt = carry
    smap = smap._replace(active=act)
    if not update_normals:
        return smap
    return smap._replace(normal=kernels.geometry_normals_finish_cuda(
        _c(smap.normal), _c(smap.valid), act, carry))


def _act_normals_finish_plain(smap, carry, update_normals):
    act, nsum, cnt = carry
    act = act & smap.valid
    smap = smap._replace(active=act)
    if not update_normals:
        return smap
    return smap._replace(normal=_renormalized(smap.normal, nsum, cnt, act))


def _activation_and_normals(chunk, finish, smap, cam, kstack, active_strict,
                            participating, baseline_fx, update_normals):
    carry = _act_normals_init(smap)
    for s in static_blocks(kstack.q.shape[0]):
        carry = chunk(carry, kstack.rows(s), active_strict[s], participating[s], smap,
                      cam, baseline_fx, update_normals)
    return finish(smap, carry, update_normals)


def update_activation_and_normals(smap, cam, kstack: KeyframeStack,
                                  active_strict: torch.Tensor,
                                  participating: torch.Tensor,
                                  baseline_fx: float,
                                  update_normals: bool = True):
    """Surfel activation (UpdateSurfelActivationCUDA: active iff associated
    with an ACTIVE keyframe) and normal averaging over the participating
    keyframes, from one association pass. Associations use the validity
    mask alone, which is exact: a surfel's association does not depend on
    its active flag. H3 on a CUDA map, the plain chain on a CPU map."""
    return _activation_and_normals(_act_normals_chunk, _act_normals_finish, smap, cam,
                                   kstack, active_strict, participating, baseline_fx,
                                   update_normals)


def update_activation_and_normals_plain(smap, cam, kstack: KeyframeStack,
                                        active_strict: torch.Tensor,
                                        participating: torch.Tensor,
                                        baseline_fx: float,
                                        update_normals: bool = True):
    """The plain chain of update_activation_and_normals, on any device."""
    return _activation_and_normals(_act_normals_chunk_plain, _act_normals_finish_plain,
                                   smap, cam, kstack, active_strict, participating,
                                   baseline_fx, update_normals)


def _normals_chunk(carry, b: KeyframeStack, smap, cam, baseline_fx):
    """One batch of the normal averaging over the active surfels:
    carry = (normal sum, observation count)."""
    if not _on_card(smap):
        return _normals_chunk_plain(carry, b, smap, cam, baseline_fx)
    nsum, cnt = carry
    kernels.geometry_normals_cuda(
        *(_c(x) for x in (smap.pos, smap.normal, smap.valid, smap.active, b.q, b.t,
                          b.depth, b.nx, b.ny)),
        cam, baseline_fx, (None, nsum, cnt), normal_mask=_c(b.mask))
    return carry


def _normals_chunk_plain(carry, b: KeyframeStack, smap, cam, baseline_fx):
    nsum, cnt = carry
    _, a = _assoc_batch(cam, smap.pos, smap.normal, smap.valid & smap.active,
                        b.q, b.t, b.depth, b.nx, b.ny, baseline_fx)
    hit = hits(a, b.mask)
    gn = _measured_normals(b.q, b.nx, b.ny, a)
    return (nsum + torch.where(hit[..., None], gn, 0.0).sum(dim=0),
            cnt + hit.sum(dim=0))


def _normals_finish(smap, carry):
    if not _on_card(smap):
        return _normals_finish_plain(smap, carry)
    return smap._replace(normal=kernels.geometry_normals_finish_cuda(
        _c(smap.normal), _c(smap.valid), _c(smap.active), (None, *carry)))


def _normals_finish_plain(smap, carry):
    nsum, cnt = carry
    return smap._replace(normal=_renormalized(smap.normal, nsum, cnt, smap.valid))


def _surfel_normals(chunk, finish, smap, cam, kstack, baseline_fx):
    _, nsum, cnt = _act_normals_init(smap)
    carry = (nsum, cnt)
    for s in static_blocks(kstack.q.shape[0]):
        carry = chunk(carry, kstack.rows(s), smap, cam, baseline_fx)
    return finish(smap, carry)


def update_surfel_normals(smap, cam, kstack: KeyframeStack, baseline_fx: float):
    """Step (a) alone: re-estimate the active surfels' normals from the
    keyframes of kstack.mask. H3 on a CUDA map, the plain chain on a CPU
    map."""
    return _surfel_normals(_normals_chunk, _normals_finish, smap, cam, kstack, baseline_fx)


def update_surfel_normals_plain(smap, cam, kstack: KeyframeStack, baseline_fx: float):
    """The plain chain of update_surfel_normals, on any device."""
    return _surfel_normals(_normals_chunk_plain, _normals_finish_plain, smap, cam, kstack,
                           baseline_fx)


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


def _pos_init(smap, use_descriptor):
    """Zeroed accumulators: (H, b) along the normal, or the 9 entries of
    the joint position + descriptor system; on a CUDA map one [2, N] or
    [8, N] tensor (kernels.geometry_position_sums: H12 is never summed)."""
    if _on_card(smap):
        return kernels.geometry_position_sums(smap.capacity, use_descriptor,
                                              smap.pos.device)
    return _pos_init_plain(smap, use_descriptor)


def _pos_init_plain(smap, use_descriptor):
    def z():
        return torch.zeros(smap.capacity, dtype=smap.pos.dtype, device=smap.pos.device)

    return tuple(z() for _ in range(9 if use_descriptor else 2))


def _pos1d_chunk(carry, b: KeyframeStack, smap, cam, baseline_fx):
    """One batch of the 1-D position system from depth residuals alone."""
    H, bb = carry
    _, a = _assoc_batch(cam, smap.pos, smap.normal, smap.valid & smap.active,
                        b.q, b.t, b.depth, b.nx, b.ny, baseline_fx)
    r, J = _depth_residual(cam, a, smap.pos.dtype)
    w = torch.where(hits(a, b.mask), robust.depth_residual_weight(r), 0.0)
    return H + torch.sum(w * J * J, dim=0), bb + torch.sum(w * r * J, dim=0)


def _pos1d_finish(smap, carry):
    H, b = carry
    upd = smap.valid & smap.active & (H > 1e-6)
    step = torch.where(upd, -b / torch.clamp_min(H, 1e-6), 0.0)
    return smap._replace(pos=smap.pos + step[:, None] * smap.normal)


def _pos3d_chunk(carry, b: KeyframeStack, smap, cam, baseline_fx, use_depth):
    """One batch of the joint position + descriptor system (3x3 per surfel)."""
    dtype = smap.pos.dtype
    H00, H01, H02, H11, H12, H22, b0, b1, b2 = carry
    ftg, a = _assoc_batch(cam, smap.pos, smap.normal, smap.valid & smap.active,
                          b.q, b.t, b.depth, b.nx, b.ny, baseline_fx)
    hit = hits(a, b.mask)
    if use_depth:
        r, Jd = _depth_residual(cam, a, dtype)
        w = torch.where(hit, robust.depth_residual_weight(r), 0.0)
        H00 = H00 + torch.sum(w * Jd * Jd, dim=0)
        b0 = b0 + torch.sum(w * r * Jd, dim=0)

    # Descriptor residuals at the tangent points.
    inten = b.intensity
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
    return H00, H01, H02, H11, H12, H22, b0, b1, b2


def _pos3d_finish(smap, carry):
    H00, H01, H02, H11, H12, H22, b0, b1, b2 = carry
    upd_mask = smap.valid & smap.active
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


def _pos_chunk(carry, b: KeyframeStack, smap, cam, baseline_fx, use_depth,
               use_descriptor):
    if not _on_card(smap):
        return _pos_chunk_plain(carry, b, smap, cam, baseline_fx, use_depth,
                                use_descriptor)
    kernels.geometry_position_cuda(
        *(_c(x) for x in (smap.pos, smap.normal, smap.radius2, smap.desc, smap.valid,
                          smap.active, b.q, b.t, b.depth, b.nx, b.ny, b.intensity, b.mask)),
        cam, baseline_fx, use_depth, use_descriptor, carry)
    return carry


def _pos_chunk_plain(carry, b: KeyframeStack, smap, cam, baseline_fx, use_depth,
                     use_descriptor):
    if use_descriptor:
        return _pos3d_chunk(carry, b, smap, cam, baseline_fx, use_depth)
    return _pos1d_chunk(carry, b, smap, cam, baseline_fx)


def _pos_finish(smap, carry, use_descriptor):
    if not _on_card(smap):
        return _pos_finish_plain(smap, carry, use_descriptor)
    pos, desc = kernels.geometry_position_finish_cuda(
        *(_c(x) for x in (smap.pos, smap.normal, smap.desc, smap.valid, smap.active)),
        carry, use_descriptor)
    return smap._replace(pos=pos, desc=desc)


def _pos_finish_plain(smap, carry, use_descriptor):
    if use_descriptor:
        return _pos3d_finish(smap, carry)
    return _pos1d_finish(smap, carry)


def _positions(init, chunk, finish, smap, cam, kstack, baseline_fx, use_depth,
               use_descriptor):
    carry = init(smap, use_descriptor)
    for s in static_blocks(kstack.q.shape[0]):
        carry = chunk(carry, kstack.rows(s), smap, cam, baseline_fx, use_depth,
                      use_descriptor)
    return finish(smap, carry, use_descriptor)


def _position_step(smap, cam, kstack: KeyframeStack, baseline_fx: float,
                   use_depth: bool, use_descriptor: bool):
    """Sum the per-surfel position (+descriptor) Gauss-Newton system over
    the masked keyframes and solve it. H3 on a CUDA map, the plain chain on
    a CPU map."""
    return _positions(_pos_init, _pos_chunk, _pos_finish, smap, cam, kstack, baseline_fx,
                      use_depth, use_descriptor)


def _position_step_plain(smap, cam, kstack: KeyframeStack, baseline_fx: float,
                         use_depth: bool, use_descriptor: bool):
    """The plain chain of _position_step, on any device."""
    return _positions(_pos_init_plain, _pos_chunk_plain, _pos_finish_plain, smap, cam,
                      kstack, baseline_fx, use_depth, use_descriptor)


def optimize_geometry_iteration(smap, cam, kstack: KeyframeStack,
                                baseline_fx: float = 40.0,
                                use_depth: bool = True,
                                use_descriptor: bool = True):
    """One full geometry step: normals, then position (+descriptors)."""
    smap = update_surfel_normals(smap, cam, kstack, baseline_fx)
    return _position_step(smap, cam, kstack, baseline_fx, use_depth,
                           use_descriptor)
