"""The reference tracker: direct multi-resolution Gauss-Newton tracking of
a frame against its base keyframe, point-to-plane depth and 2-component
descriptor residuals.

A frozen copy of the port's plain version (``tracking/pairwise.py`` with
the host loop: one read of the convergence flag per iteration) as it stood
when the benchmark was defined. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple, Union

import torch

from slam_bench.reference import geometry as se3
from slam_bench.reference import frame as robust
from slam_bench.reference.frame import (
    FramePyramidLevel,
    bilinear_and_gradient,
    gather_nearest_plain as gather_nearest,
    normal_z,
    shift2d,
)
from slam_bench.reference.geometry import PinholeCamera, solve_psd


_SCALE_N_TRANS_THR = 1e-8


_SCALE_N_ROT_THR = 1e-8


class TrackingResult(NamedTuple):
    q: torch.Tensor  # base_T_frame quaternion (wxyz)
    t: torch.Tensor  # base_T_frame translation
    cost: torch.Tensor  # final-scale cost (diagnostic)
    residual_count: torch.Tensor
    # Whether the finest level hit its convergence test: a bool from the
    # host loop, a device bool tensor from the others.
    converged: Union[bool, torch.Tensor]
    # Gauss-Newton iterations run per scale (index = scale): ints from the
    # host loop, device int64 scalars from the others.
    iterations: tuple = ()


def _transform_planes(R: torch.Tensor, t: torch.Tensor, x, y, z):
    """Apply [3,3] rotation + translation to plane triplets."""
    ox = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    oy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    oz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    return ox, oy, oz


def _rotate_planes(R: torch.Tensor, x, y, z):
    ox = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z
    oy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z
    oz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z
    return ox, oy, oz


def _image_residuals(
    cam: PinholeCamera,
    base: FramePyramidLevel,
    tracked: FramePyramidLevel,
    frame_q: torch.Tensor,
    frame_t: torch.Tensor,
    threshold_factor: float,
    baseline_fx: float,
    use_depth: bool,
    use_descriptor: bool,
    with_jacobians: bool,
    use_gradmag: bool = False,
):
    """Residual/Jacobian evaluation over all base-frame pixels.

    `frame_q/t` is frame_T_base (the inverse of the estimate being tracked).
    Returns a dict with masks, residuals, weights and (optionally) Jacobian
    plane lists for each enabled residual type.
    """
    h, w = base.depth.shape
    dtype = base.depth.dtype
    device = base.depth.device
    R = se3.quat_to_matrix(frame_q)

    ys = torch.arange(h, device=device, dtype=dtype)[:, None].expand(h, w)
    xs = torch.arange(w, device=device, dtype=dtype)[None, :].expand(h, w)

    d_b = base.depth
    valid = d_b > 0

    # Unproject base pixels (pixel-center convention).
    nxs = cam.fx_inv * xs + cam.cx_inv
    nys = cam.fy_inv * ys + cam.cy_inv
    pbx = d_b * nxs
    pby = d_b * nys
    pbz = d_b

    # Into the tracked frame.
    ltx, lty, ltz = _transform_planes(R, frame_t, pbx, pby, pbz)
    valid &= ltz > 0

    # Project (corner convention), floor to pixel indices, bounds test.
    safe_z = torch.where(valid, ltz, 1.0)
    pxy_x = cam.fx * ltx / safe_z + cam.cx
    pxy_y = cam.fy * lty / safe_z + cam.cy
    px_f = torch.floor(pxy_x)
    py_f = torch.floor(pxy_y)
    valid &= (pxy_x >= 0) & (pxy_y >= 0) & (px_f < w) & (py_f < h) \
        & (px_f >= 0) & (py_f >= 0)
    # Convert, then clamp (as the JAX package does), so that any coordinate
    # of an invalid pixel still gathers in bounds.
    pxc = torch.clamp(px_f.to(torch.int64), 0, w - 1)
    pyc = torch.clamp(py_f.to(torch.int64), 0, h - 1)

    # Tracked-frame measurements at the projected pixel.
    d_t = gather_nearest(tracked.depth, pxc, pyc)
    valid &= d_t > 0

    # Base normal rotated into the tracked frame.
    nbz = normal_z(base.nx, base.ny)
    nlx, nly, nlz = _rotate_planes(R, base.nx, base.ny, nbz)

    # Association test.
    un_x = cam.fx_inv * pxc.to(dtype) + cam.cx_inv
    un_y = cam.fy_inv * pyc.to(dtype) + cam.cy_inv
    stddev = (
        robust.DEPTH_UNCERTAINTY_EMPIRICAL_FACTOR
        * torch.abs(nlx * un_x + nly * un_y + nlz)
        * (d_t * d_t)
    ) / baseline_fx
    depth_tukey_param = threshold_factor * robust.DEPTH_TUKEY_PARAM
    valid &= torch.abs(ltz - d_t) <= depth_tukey_param * stddev
    # Surfel must face the camera.
    valid &= (ltx * nlx + lty * nly + ltz * nlz) <= 0
    # Normal compatibility with the measurement.
    ntx = gather_nearest(tracked.nx, pxc, pyc)
    nty = gather_nearest(tracked.ny, pxc, pyc)
    ntz = normal_z(ntx, nty)
    valid &= (nlx * ntx + nly * nty + nlz * ntz) \
        >= robust.COS_NORMAL_COMPATIBILITY_THRESHOLD

    out = {"h": h, "w": w}

    if use_depth:
        inv_stddev = 1.0 / torch.clamp_min(stddev, 1e-30)
        # Tracked pixel unprojected with the measured depth.
        ux = d_t * un_x
        uy = d_t * un_y
        uz = d_t
        r_d = inv_stddev * (nlx * (ux - ltx) + nly * (uy - lty) + nlz * (uz - ltz))
        r_d = torch.where(valid, r_d, 0.0)
        out["depth_residual"] = r_d
        out["depth_weight"] = torch.where(
            valid, robust.depth_residual_weight(r_d, threshold_factor), 0.0)
        if with_jacobians:
            out["depth_jacobian"] = [
                inv_stddev * nlx,
                inv_stddev * nly,
                inv_stddev * nlz,
                inv_stddev * (-nly * uz + nlz * uy),
                inv_stddev * (nlx * uz - nlz * ux),
                inv_stddev * (-nlx * uy + nly * ux),
            ]

    if use_descriptor:
        desc_valid = valid
        # Descriptors computable only where right/down neighbors exist.
        desc_valid = desc_valid & (xs < w - 1) & (ys < h - 1)
        i_c = base.intensity
        i_r = shift2d(base.intensity, 0, 1)
        i_dn = shift2d(base.intensity, 1, 0)
        desc1 = 180.0 * (i_r - i_c)
        desc2 = 180.0 * (i_dn - i_c)

        # Plane through the base point with the base normal: estimate the
        # depths of the +x / +y neighbor pixels on that plane.
        plane_d = (nxs * d_b) * base.nx + (nys * d_b) * base.ny + d_b * nbz
        nxs_r = cam.fx_inv * (xs + 1.0) + cam.cx_inv
        nys_d = cam.fy_inv * (ys + 1.0) + cam.cy_inv
        denom1 = nxs_r * base.nx + nys * base.ny + nbz
        denom2 = nxs * base.nx + nys_d * base.ny + nbz
        ok1 = torch.abs(denom1) > 1e-12
        ok2 = torch.abs(denom2) > 1e-12
        desc_valid = desc_valid & ok1 & ok2
        t1_depth = plane_d / torch.where(ok1, denom1, 1.0)
        t2_depth = plane_d / torch.where(ok2, denom2, 1.0)

        t1x, t1y, t1z = _transform_planes(
            R, frame_t, t1_depth * nxs_r, t1_depth * nys, t1_depth)
        t2x, t2y, t2z = _transform_planes(
            R, frame_t, t2_depth * nxs, t2_depth * nys_d, t2_depth)
        desc_valid = desc_valid & (t1z > 0) & (t2z > 0)
        s1 = torch.where(t1z > 0, t1z, 1.0)
        s2 = torch.where(t2z > 0, t2z, 1.0)
        t1_px = cam.fx * t1x / s1 + cam.cx
        t1_py = cam.fy * t1y / s1 + cam.cy
        t2_px = cam.fx * t2x / s2 + cam.cx
        t2_py = cam.fy * t2y / s2 + cam.cy
        desc_valid = desc_valid & (
            (t1_px >= 0) & (t1_py >= 0)
            & (torch.floor(t1_px) < w) & (torch.floor(t1_py) < h)
            & (t2_px >= 0) & (t2_py >= 0)
            & (torch.floor(t2_px) < w) & (torch.floor(t2_py) < h)
        )

        ic_t, c_dx, c_dy = bilinear_and_gradient(tracked.intensity, pxy_x, pxy_y)
        i1_t, t1_dx, t1_dy = bilinear_and_gradient(tracked.intensity, t1_px, t1_py)
        i2_t, t2_dx, t2_dy = bilinear_and_gradient(tracked.intensity, t2_px, t2_py)

        r1 = torch.where(desc_valid, 180.0 * (i1_t - ic_t) - desc1, 0.0)
        r2 = torch.where(desc_valid, 180.0 * (i2_t - ic_t) - desc2, 0.0)
        if with_jacobians:
            gx1 = 180.0 * (t1_dx - c_dx) * cam.fx
            gy1 = 180.0 * (t1_dy - c_dy) * cam.fy
            gx2 = 180.0 * (t2_dx - c_dx) * cam.fx
            gy2 = 180.0 * (t2_dy - c_dy) * cam.fy
            inv_z = 1.0 / torch.where(valid, ltz, 1.0)
            inv_z_sq = inv_z * inv_z
            z_sq = ltz * ltz
            xy = ltx * lty

            def desc_jac(gx, gy):
                return [
                    -gx * inv_z,
                    -gy * inv_z,
                    (ltx * gx + lty * gy) * inv_z_sq,
                    ((lty * lty + z_sq) * gy + xy * gx) * inv_z_sq,
                    -((ltx * ltx + z_sq) * gx + xy * gy) * inv_z_sq,
                    -(ltx * gy - lty * gx) * inv_z,
                ]

            out["desc_jacobian_1"] = desc_jac(gx1, gy1)
            out["desc_jacobian_2"] = desc_jac(gx2, gy2)

        # Where the descriptor cannot be computed the whole pixel is
        # invalid, depth residual included.
        valid = desc_valid
        if use_depth:
            out["depth_residual"] = torch.where(valid, out["depth_residual"], 0.0)
            out["depth_weight"] = torch.where(valid, out["depth_weight"], 0.0)
        out["desc_valid"] = desc_valid
        out["desc_residual_1"] = r1
        out["desc_residual_2"] = r2
        out["desc_weight_1"] = torch.where(
            valid, robust.descriptor_residual_weight(r1, threshold_factor), 0.0)
        out["desc_weight_2"] = torch.where(
            valid, robust.descriptor_residual_weight(r2, threshold_factor), 0.0)

    if use_gradmag:
        # Gradient-magnitude residual: pyramids carry gradmag planes in
        # `intensity`. One residual per pixel: 255 * (I_t(proj) - I_b(pixel)).
        gm_t, g_dx, g_dy = bilinear_and_gradient(tracked.intensity, pxy_x, pxy_y)
        r_g = torch.where(valid, 255.0 * gm_t - 255.0 * base.intensity, 0.0)
        out["gradmag_residual"] = r_g
        out["gradmag_weight"] = torch.where(
            valid, robust.descriptor_residual_weight(r_g, threshold_factor), 0.0)
        if with_jacobians:
            gx = 255.0 * g_dx * cam.fx
            gy = 255.0 * g_dy * cam.fy
            inv_z = 1.0 / torch.where(valid, ltz, 1.0)
            inv_z_sq = inv_z * inv_z
            z_sq = ltz * ltz
            xy = ltx * lty
            out["gradmag_jacobian"] = [
                -gx * inv_z,
                -gy * inv_z,
                (ltx * gx + lty * gy) * inv_z_sq,
                ((lty * lty + z_sq) * gy + xy * gx) * inv_z_sq,
                -((ltx * ltx + z_sq) * gx + xy * gy) * inv_z_sq,
                -(ltx * gy - lty * gx) * inv_z,
            ]

    out["valid"] = valid
    return out


def _accumulate_h_b(res, use_depth: bool, use_descriptor: bool,
                    use_gradmag: bool = False):
    """Stack the residual terms as [P, 7] = [J0..J5, r] and reduce
    H = (w A)^T A [:6, :6], b = (w A)^T A [:6, 6], summed over residual types.

    The product runs in full float32: the front end turns TF32 off, as the
    JAX package reduces at Precision.HIGHEST."""
    terms = []
    if use_depth:
        terms.append((res["depth_jacobian"], res["depth_residual"], res["depth_weight"]))
    if use_descriptor:
        terms.append((res["desc_jacobian_1"], res["desc_residual_1"], res["desc_weight_1"]))
        terms.append((res["desc_jacobian_2"], res["desc_residual_2"], res["desc_weight_2"]))
    if use_gradmag:
        terms.append((res["gradmag_jacobian"], res["gradmag_residual"],
                      res["gradmag_weight"]))

    device = res["valid"].device
    H = torch.zeros((6, 6), dtype=torch.float32, device=device)
    b = torch.zeros((6,), dtype=torch.float32, device=device)
    for jac, r, wt in terms:
        A = torch.stack(jac + [r], dim=-1).reshape(-1, 7).to(torch.float32)
        wA = A * wt.reshape(-1, 1).to(torch.float32)
        M = wA.T @ A
        H = H + M[:6, :6]
        b = b + M[:6, 6]
    return H, b


def _cost_and_count(res, threshold_factor, use_depth: bool,
                    use_descriptor: bool, use_gradmag: bool = False):
    """Total robust cost + residual count (the duel heuristic inputs)."""
    valid = res["valid"]
    device = valid.device
    cost = torch.zeros((), dtype=torch.float32, device=device)
    count = torch.zeros((), dtype=torch.int64, device=device)
    n_valid = valid.sum()
    if use_depth:
        cost = cost + torch.where(
            valid,
            robust.weighted_depth_residual(res["depth_residual"], threshold_factor),
            0.0).sum()
        count = count + n_valid
    if use_descriptor:
        cost = cost + torch.where(
            valid,
            robust.weighted_descriptor_residual(res["desc_residual_1"], threshold_factor)
            + robust.weighted_descriptor_residual(res["desc_residual_2"], threshold_factor),
            0.0).sum()
        if not use_depth:
            count = count + n_valid
    if use_gradmag:
        cost = cost + torch.where(
            valid,
            robust.weighted_descriptor_residual(res["gradmag_residual"], threshold_factor),
            0.0).sum()
        if not use_depth:
            count = count + n_valid
    return cost, count


def accumulate_pose_coeffs(
    cam: PinholeCamera,
    base: FramePyramidLevel,
    tracked: FramePyramidLevel,
    base_T_frame_q: torch.Tensor,
    base_T_frame_t: torch.Tensor,
    threshold_factor,
    baseline_fx: float,
    use_depth: bool = True,
    use_descriptor: bool = True,
    use_gradmag: bool = False,
):
    """One GN accumulation: returns (H[6,6], b[6], count)."""
    frame_T_base = se3.inverse(se3.SE3(base_T_frame_q, base_T_frame_t))
    res = _image_residuals(
        cam, base, tracked, frame_T_base.q, frame_T_base.t,
        threshold_factor, baseline_fx, use_depth, use_descriptor, True,
        use_gradmag,
    )
    H, b = _accumulate_h_b(res, use_depth, use_descriptor, use_gradmag)
    return H, b, res["valid"].sum()


def compute_cost_and_count(
    cam, base, tracked, base_T_frame_q, base_T_frame_t,
    threshold_factor, baseline_fx, use_depth=True, use_descriptor=True,
    use_gradmag=False,
):
    frame_T_base = se3.inverse(se3.SE3(base_T_frame_q, base_T_frame_t))
    res = _image_residuals(
        cam, base, tracked, frame_T_base.q, frame_T_base.t,
        threshold_factor, baseline_fx, use_depth, use_descriptor, False,
        use_gradmag,
    )
    return _cost_and_count(res, threshold_factor, use_depth, use_descriptor,
                           use_gradmag)


def device_constants(device: torch.device) -> Dict[str, torch.Tensor]:
    """The scale vector of the convergence test and the 6x6 identity."""
    return {
        "conv_scale": torch.tensor(
            [1.0, 1.0, 1.0] + [_SCALE_N_TRANS_THR / _SCALE_N_ROT_THR] * 3,
            dtype=torch.float32, device=device),
        "eye": torch.eye(6, dtype=torch.float32, device=device),
    }


def _is_converged(x: torch.Tensor, scaling_factor: float) -> torch.Tensor:
    """Scale-N pose-estimation convergence test on a GN step x."""
    scaled = x * device_constants(x.device)["conv_scale"]
    return torch.sum(scaled * scaled) < (
        scaling_factor * scaling_factor * _SCALE_N_TRANS_THR)


def _gn_step(cam, base, tracked, q, t, scaling_factor, damping, baseline_fx,
             use_depth, use_descriptor, use_gradmag):
    """One Gauss-Newton iteration on the device: returns (q, t, converged)
    with `converged` a device bool."""
    H, b, count = accumulate_pose_coeffs(
        cam, base, tracked, q, t, scaling_factor, baseline_fx,
        use_depth, use_descriptor, use_gradmag,
    )
    # Guard the solve: with no residuals, keep the pose.
    ok = count > 6
    x = solve_psd(torch.where(ok, H, device_constants(q.device)["eye"]), b)
    x = torch.where(ok & torch.isfinite(x).all(), x, 0.0)
    q, t = se3.mul(se3.SE3(q, t), se3.exp(-damping * x))
    return q, t, _is_converged(x, scaling_factor)


def _gn_level(
    cam, base, tracked, q, t, scaling_factor, damping, baseline_fx,
    use_depth, use_descriptor, max_iterations, use_gradmag=False,
):
    """Gauss-Newton at one pyramid level with early exit: stops at
    `max_iterations` or on convergence, reading the flag once per
    iteration. Returns (q, t, converged, iterations)."""
    converged = False
    it = 0
    while it < max_iterations and not converged:
        q, t, flag = _gn_step(cam, base, tracked, q, t, scaling_factor, damping,
                              baseline_fx, use_depth, use_descriptor, use_gradmag)
        converged = bool(flag)
        it += 1
    return q, t, converged, it


def _duel(cam, base, tracked, qa, ta, qb, tb, threshold_factor, baseline_fx,
          use_depth, use_descriptor, use_gradmag=False):
    """Pick the better of two pose hypotheses (on the device, no sync)."""
    cost_a, count_a = compute_cost_and_count(
        cam, base, tracked, qa, ta, threshold_factor, baseline_fx,
        use_depth, use_descriptor, use_gradmag)
    cost_b, count_b = compute_cost_and_count(
        cam, base, tracked, qb, tb, threshold_factor, baseline_fx,
        use_depth, use_descriptor, use_gradmag)
    pick_a = (count_a > 2 * count_b) | (
        ~(count_b > 2 * count_a) & (cost_a < cost_b))
    return torch.where(pick_a, qa, qb), torch.where(pick_a, ta, tb)


def track_frame_pairwise(
    cams: Tuple[PinholeCamera, ...],
    base_pyramid: Tuple[FramePyramidLevel, ...],
    tracked_pyramid: Tuple[FramePyramidLevel, ...],
    init1_q: torch.Tensor,
    init1_t: torch.Tensor,
    init2_q: torch.Tensor,
    init2_t: torch.Tensor,
    baseline_fx: float = 40.0,
    use_depth: bool = True,
    use_descriptor: bool = True,
    use_gradmag: bool = False,
    test_two_initial_estimates: bool = False,
    max_iterations: int = 30,
    use_pyramid_level_0: bool = True,
) -> TrackingResult:
    """Estimate base_T_frame aligning `tracked` to `base`, coarse to fine.

    `cams`/pyramids are finest-first tuples of levels. The initial
    estimates are base_T_frame (e.g. from the constant-motion model). The
    coarsest scale duels the two estimates only when
    `test_two_initial_estimates`; every finer scale duels the current pose
    against the one chosen at the coarsest scale.
    """
    num_scales = len(cams)
    q, t = init1_q, init1_t
    chosen_q, chosen_t = init1_q, init1_t
    converged = False
    iterations: List = [0] * num_scales

    finest = 0 if use_pyramid_level_0 else 1
    for scale in range(num_scales - 1, finest - 1, -1):
        cam = cams[scale]
        base = base_pyramid[scale]
        tracked = tracked_pyramid[scale]
        scaling_factor = float(2 ** scale)
        if scale == num_scales - 1:
            damping = 0.25
        elif scale == num_scales - 2:
            damping = 0.5
        else:
            damping = 1.0

        if scale == num_scales - 1:
            if test_two_initial_estimates:
                q, t = _duel(
                    cam, base, tracked, init1_q, init1_t, init2_q, init2_t,
                    scaling_factor, baseline_fx, use_depth, use_descriptor,
                    use_gradmag,
                )
            chosen_q, chosen_t = q, t
        else:
            q, t = _duel(
                cam, base, tracked, q, t, chosen_q, chosen_t,
                scaling_factor, baseline_fx, use_depth, use_descriptor,
                use_gradmag,
            )

        q, t, converged, iterations[scale] = _gn_level(
            cam, base, tracked, q, t, scaling_factor, damping, baseline_fx,
            use_depth, use_descriptor, max_iterations, use_gradmag,
        )

    cost, count = compute_cost_and_count(
        cams[finest], base_pyramid[finest], tracked_pyramid[finest], q, t,
        float(2 ** finest), baseline_fx, use_depth, use_descriptor,
        use_gradmag,
    )
    return TrackingResult(q=q, t=t, cost=cost, residual_count=count,
                          converged=converged, iterations=tuple(iterations))

