"""Keyframe pose optimization against the surfel map.

Counterpart of ``badslam_tpu/ba/pose_opt.py`` (DirectBA::EstimateFramePose
and the surfel pose cost, direct_ba_alternating.cc:42-283,
kernel_opt_pose.cu:251-420): Gauss-Newton on each keyframe's 6-DoF pose
with depth (point-to-plane, Tukey) and descriptor (tangent-point intensity,
Huber) residuals over all surfels.

``surfel_pose_coeffs`` is the step's accumulation: on a CUDA tensor it
launches H2 (``csrc/pose_coeffs.cu``, one kernel over the live surfel rows
and the running keyframes, no per-surfel field in memory), on a CPU
tensor it runs the plain version, ``surfel_pose_coeffs_plain``.

The keyframes run in fixed blocks of ``KEYFRAME_BATCH`` slots
(``static_blocks``, the JAX package's chunks), each block in lockstep:
every Gauss-Newton step associates all surfels with the block's running
keyframes at once and solves C 6x6 systems. Only the keyframes of the mask
run; one whose own loop has ended (converged, or 30 steps) keeps its pose
while the others go on, exactly as the JAX package's vmapped while_loop,
and is left out of the accumulation (zeros). The block's loop runs while
any of its keyframes runs, under a loop control (``ops.conditional``): the
host loop (one flag read back per step, as the CUDA original did), the
masked plain version (every step, no read) or, inside a captured CUDA
graph, one WHILE node per block, so the card decides each block's exit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from badslam_torch.geometry import se3
from badslam_torch.geometry.linalg import solve_psd
from badslam_torch.mapping.association import (
    associate_surfels_with_frame,
    tangent_projections,
)
from badslam_torch.mapping.keyframes import KeyframeStack, static_blocks
from badslam_torch.ops import kernels, robust
from badslam_torch.ops.conditional import HOST, Control, loop
from badslam_torch.ops.interp import bilinear_and_gradient

# Scale-1 convergence thresholds (convergence_analysis.h:45-52).
_TRANS_THR = 1e-6
_ROT_THR = 1e-7


def is_scale1_converged(x: torch.Tensor) -> torch.Tensor:
    """[..., 6] steps -> [...] bool."""
    scale = _TRANS_THR / _ROT_THR
    scaled = torch.cat([x[..., :3], x[..., 3:] * scale], dim=-1)
    return torch.sum(scaled * scaled, dim=-1) < _TRANS_THR


def surfel_pose_coeffs(smap, cam, kf_q, kf_t, depth, f_nx, f_ny, intensity,
                       baseline_fx: float, use_depth: bool,
                       use_descriptor: bool, running=None):
    """One Gauss-Newton accumulation over all surfels for keyframe pose(s)
    global_T_frame (kf_q [4] or [C, 4]) with their planes ([H, W] or
    [C, H, W]). Returns (H [..., 6, 6], b [..., 6], count [...]); a
    keyframe outside `running` ([...] bool, None for all) gets zeros.
    H2 on a CUDA tensor, the plain version on a CPU tensor."""
    if smap.pos.is_cuda:
        ftg = se3.inverse(se3.SE3(kf_q, kf_t))
        return kernels.pose_coeffs_cuda(
            *(x.contiguous() for x in (smap.pos, smap.normal, smap.radius2,
                                       smap.desc, smap.valid)),
            se3.quat_to_matrix(ftg.q).contiguous(), ftg.t.contiguous(),
            *(x.contiguous() for x in (depth, f_nx, f_ny, intensity)),
            cam, baseline_fx, use_depth, use_descriptor,
            None if running is None else running.contiguous())
    if smap.pos.device.type != "cpu":
        raise ValueError(f"no surfel pose coefficients for device {smap.pos.device}")
    return surfel_pose_coeffs_plain(smap, cam, kf_q, kf_t, depth, f_nx, f_ny,
                                    intensity, baseline_fx, use_depth,
                                    use_descriptor, running)


def surfel_pose_coeffs_plain(smap, cam, kf_q, kf_t, depth, f_nx, f_ny,
                             intensity, baseline_fx: float, use_depth: bool,
                             use_descriptor: bool, running=None):
    """Plain PyTorch version of surfel_pose_coeffs (and of H2), on any
    device."""
    ftg = se3.inverse(se3.SE3(kf_q, kf_t))
    a = associate_surfels_with_frame(
        cam, smap.pos, smap.normal, smap.valid, ftg.q, ftg.t,
        depth, f_nx, f_ny, baseline_fx)
    valid = a.valid
    dtype = smap.pos.dtype

    terms = []
    if use_depth:
        inv_stddev = 1.0 / torch.clamp_min(a.stddev, 1e-30)
        un_x = cam.fx_inv * a.px.to(dtype) + cam.cx_inv
        un_y = cam.fy_inv * a.py.to(dtype) + cam.cy_inv
        ux = a.pixel_depth * un_x
        uy = a.pixel_depth * un_y
        uz = a.pixel_depth
        r_d = inv_stddev * (a.nlx * (ux - a.lx) + a.nly * (uy - a.ly)
                            + a.nlz * (uz - a.lz))
        r_d = torch.where(valid, r_d, 0.0)
        w_d = torch.where(valid, robust.depth_residual_weight(r_d), 0.0)
        jac = [
            inv_stddev * a.nlx,
            inv_stddev * a.nly,
            inv_stddev * a.nlz,
            inv_stddev * (-a.nly * uz + a.nlz * uy),
            inv_stddev * (a.nlx * uz - a.nlz * ux),
            inv_stddev * (-a.nlx * uy + a.nly * ux),
        ]
        terms.append((jac, r_d, w_d))

    if use_descriptor:
        t1x, t1y, t2x, t2y, t_ok = tangent_projections(
            smap.pos, smap.normal, smap.radius2, ftg.q, ftg.t, cam)
        dvalid = valid & t_ok
        ic, c_dx, c_dy = bilinear_and_gradient(intensity, a.pxy_x, a.pxy_y)
        i1, t1_dx, t1_dy = bilinear_and_gradient(intensity, t1x, t1y)
        i2, t2_dx, t2_dy = bilinear_and_gradient(intensity, t2x, t2y)
        r1 = torch.where(dvalid, 180.0 * (i1 - ic) - smap.desc[:, 0], 0.0)
        r2 = torch.where(dvalid, 180.0 * (i2 - ic) - smap.desc[:, 1], 0.0)
        w1 = torch.where(dvalid, robust.descriptor_residual_weight(r1), 0.0)
        w2 = torch.where(dvalid, robust.descriptor_residual_weight(r2), 0.0)

        inv_z = 1.0 / torch.where(dvalid, a.lz, 1.0)
        inv_z_sq = inv_z * inv_z
        z_sq = a.lz * a.lz
        xy = a.lx * a.ly

        def desc_jac(gx_raw, gy_raw):
            gx = 180.0 * (gx_raw - c_dx) * cam.fx
            gy = 180.0 * (gy_raw - c_dy) * cam.fy
            return [
                -gx * inv_z,
                -gy * inv_z,
                (a.lx * gx + a.ly * gy) * inv_z_sq,
                ((a.ly * a.ly + z_sq) * gy + xy * gx) * inv_z_sq,
                -((a.lx * a.lx + z_sq) * gx + xy * gy) * inv_z_sq,
                -(a.lx * gy - a.ly * gx) * inv_z,
            ]

        terms.append((desc_jac(t1_dx, t1_dy), r1, w1))
        terms.append((desc_jac(t2_dx, t2_dy), r2, w2))

    batch = valid.shape[:-1]
    H = torch.zeros(batch + (6, 6), dtype=torch.float32, device=valid.device)
    b = torch.zeros(batch + (6,), dtype=torch.float32, device=valid.device)
    for jac, r, wt in terms:
        A = torch.stack(jac + [r], dim=-1)  # [..., N, 7]
        # A float32 matmul (TF32 stays off; the JAX package reduces at
        # Precision.HIGHEST).
        M = torch.matmul((A * wt[..., None]).transpose(-1, -2), A)
        H = H + M[..., :6, :6]
        b = b + M[..., :6, 6]
    count = valid.sum(dim=-1)
    if running is None:
        return H, b, count
    return (torch.where(running[..., None, None], H, 0.0),
            torch.where(running[..., None], b, 0.0), torch.where(running, count, 0))


class PoseOptResult(NamedTuple):
    q: torch.Tensor      # [K, 4] updated global_T_frame rotations
    t: torch.Tensor      # [K, 3]
    moved: torch.Tensor  # [K] bool: pose changed beyond the scale-1 threshold


def _estimate_poses(smap, cam, b: KeyframeStack, baseline_fx, use_depth,
                    use_descriptor, max_iterations, control: Control = HOST):
    """The Gauss-Newton loops of a block of C keyframes, in lockstep, for
    the keyframes of b.mask; each keyframe stops updating when its own loop
    ends, and the block's loop when all have ended."""
    eye = torch.eye(6, dtype=torch.float32, device=b.q.device)

    def running_any(state):
        return state[2].any()

    def step(state):
        q, t, running = state
        H, rhs, count = surfel_pose_coeffs(
            smap, cam, q, t, b.depth, b.nx, b.ny, b.intensity, baseline_fx,
            use_depth, use_descriptor, running)
        ok = count > 6
        x = solve_psd(torch.where(ok[:, None, None], H, eye), rhs)
        x = torch.where((ok & torch.all(torch.isfinite(x), dim=-1))[:, None],
                        x, 0.0)
        upd = se3.mul(se3.SE3(q, t), se3.exp(-x))
        return (torch.where(running[:, None], upd.q, q),
                torch.where(running[:, None], upd.t, t),
                running & ~is_scale1_converged(x))

    (q, t, _), _ = loop(control, (b.q, b.t, b.mask), running_any, step,
                        most=max_iterations, name="pose")
    return q, t


def optimize_keyframe_poses(smap, cam, kstack: KeyframeStack,
                            baseline_fx: float = 40.0, use_depth: bool = True,
                            use_descriptor: bool = True,
                            max_iterations: int = 30,
                            loop: Control = HOST) -> PoseOptResult:
    """Optimize every masked keyframe's pose against the (fixed) map; the
    others pass through unchanged. Poses are independent given the map, so
    the blocking does not change the result. `loop`: the Gauss-Newton loop
    control (module docstring)."""
    q0, t0 = kstack.q, kstack.t
    out = [_estimate_poses(smap, cam, kstack.rows(s), baseline_fx, use_depth,
                           use_descriptor, max_iterations, loop)
           for s in static_blocks(q0.shape[0])]
    q = torch.cat([o[0] for o in out])
    t = torch.cat([o[1] for o in out])
    diff = se3.mul(se3.inverse(se3.SE3(q0, t0)), se3.SE3(q, t))
    moved = kstack.mask & ~is_scale1_converged(se3.log(diff))
    return PoseOptResult(q=q, t=t, moved=moved)
