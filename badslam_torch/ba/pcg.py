"""PCG bundle adjustment: one global Gauss-Newton system, matrix-free.

Counterpart of ``badslam_tpu/ba/pcg.py`` (DirectBA::BundleAdjustmentPCG,
direct_ba_pcg.cc:43-700 and kernel_pcg.cu): instead of alternating pose and
geometry steps, one Gauss-Newton system over all unknowns, solved inexactly
with Jacobi-preconditioned conjugate gradients on the normal equations
J^T W J x = -J^T W r with matrix-free products.

Unknowns (direct_ba_pcg.cc:270-307, minus the gauge keyframe):
  * 6 per keyframe (se3 twist, right-multiplied),
  * 1 per surfel (position offset along its normal),
  * 2 per surfel (descriptor components) with photometric residuals,
  * with optimize_intrinsics, 5 intrinsics (fx_inv, fy_inv, cx_inv, cy_inv,
    a) and 1 cfactor per sparsification cell; the photometric residuals'
    intrinsics Jacobians are chain-ruled into the same 5 (one shared camera,
    as in the JAX package).

As there, the per-(keyframe, surfel) coefficients are recomputed in every
product (as kernel_pcg.cu recomputes them per step), over the keyframes in
batches of up to ``KEYFRAME_BATCH`` ([C, N] fields, so memory stays bounded
by the batch, not the keyframe count). The CG loop is the CUDA original's
host loop: its stopping rule (step count, 3 non-improving residual norms,
rz) is read back once per step. The inner products leave out the
intrinsics and cfactor unknowns, as the JAX package's do (`_dot`). Segment
sums over cells are ``index_add_``, which on CUDA tensors adds in no fixed
order.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from badslam_torch.ba.geometry_opt import update_surfel_normals
from badslam_torch.ba.intrinsics_opt import A_PRIOR_WEIGHT, DepthParams
from badslam_torch.geometry import se3
from badslam_torch.mapping import surfels as sf
from badslam_torch.mapping.association import (
    associate_surfels_with_frame,
    tangent_projections,
)
from badslam_torch.mapping.keyframes import KeyframeStack, keyframe_batches
from badslam_torch.ops import robust
from badslam_torch.ops.conditional import HOST
from badslam_torch.ops.interp import bilinear_and_gradient, gather_nearest

DIAG_EPSILON = 1e-8  # kDiagEpsilon (kernel_pcg.cu:44)


class Unknowns(NamedTuple):
    """The global unknown vector."""

    pose: torch.Tensor     # [K, 6]
    geo: torch.Tensor      # [N] position offset along the surfel normal
    desc: torch.Tensor     # [N, 2]
    intr: torch.Tensor     # [5] fx_inv, fy_inv, cx_inv, cy_inv, a
    cfactor: torch.Tensor  # [C] per-sparsification-cell deformation


def _zeros_like_unknowns(k: int, n: int, c: int, device) -> Unknowns:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return Unknowns(pose=z(k, 6), geo=z(n), desc=z(n, 2), intr=z(5), cfactor=z(c))


def _dot(a: Unknowns, b: Unknowns) -> torch.Tensor:
    """The CG inner product over pose, geo and desc: intr and cfactor are
    left out, as in the JAX package."""
    return (torch.dot(a.pose.reshape(-1), b.pose.reshape(-1))
            + torch.dot(a.geo, b.geo)
            + torch.dot(a.desc.reshape(-1), b.desc.reshape(-1)))


def _axpy(alpha, x: Unknowns, y: Unknowns) -> Unknowns:
    return Unknowns(*(alpha * xi + yi for xi, yi in zip(x, y)))


def _scale(m: Unknowns, r: Unknowns) -> Unknowns:
    return Unknowns(*(mi * ri for mi, ri in zip(m, r)))


def _coeffs_for_keyframes(smap, cam, kstack: KeyframeStack, raw_depth, s,
                          baseline_fx: float, use_depth: bool,
                          use_descriptor: bool, params: DepthParams,
                          cell_size: int, wc: int,
                          optimize_intrinsics: bool) -> List[dict]:
    """Per-surfel residuals and Jacobians of the keyframes `s` (a slice or
    index tensor of masked slots) against the map, as [C, N] fields.

    Returns the residual groups (depth, then the two descriptor slots), each
    a dict with: w robust weight (0 where invalid), r residual, jp [C, N, 6]
    pose Jacobian, jg geometry Jacobian (or None), jd descriptor slot (or
    None) and, with optimize_intrinsics, ji [C, N, 5] intrinsics Jacobian
    plus (depth group) jcf cfactor Jacobian and cell ids (else None)."""
    ftg = se3.inverse(se3.SE3(kstack.q[s], kstack.t[s]))
    a = associate_surfels_with_frame(
        cam, smap.pos, smap.normal, smap.valid & smap.active, ftg.q, ftg.t,
        kstack.depth[s], kstack.nx[s], kstack.ny[s], baseline_fx)
    valid = a.valid & kstack.mask[s][:, None]
    dtype = smap.pos.dtype
    pxf = a.px.to(dtype)
    pyf = a.py.to(dtype)
    groups = []

    if use_depth:
        # Zero (not just down-weight) invalid rows: 1e30-scale Jacobians of
        # degenerate stddevs would give inf * 0 = NaN in the products.
        inv_stddev = torch.where(valid, 1.0 / torch.clamp_min(a.stddev, 1e-30), 0.0)
        un_x = cam.fx_inv * pxf + cam.cx_inv
        un_y = cam.fy_inv * pyf + cam.cy_inv
        ux, uy, uz = a.pixel_depth * un_x, a.pixel_depth * un_y, a.pixel_depth
        r = inv_stddev * (a.nlx * (ux - a.lx) + a.nly * (uy - a.ly)
                          + a.nlz * (uz - a.lz))
        w = torch.where(valid, robust.depth_residual_weight(r), 0.0)
        # The exact pose Jacobian (rotation rows from the surfel's local
        # position): the alternating solver's simplification would create
        # spurious joint stationary points here.
        jp = torch.stack([
            inv_stddev * a.nlx,
            inv_stddev * a.nly,
            inv_stddev * a.nlz,
            inv_stddev * (-a.nly * a.lz + a.nlz * a.ly),
            inv_stddev * (a.nlx * a.lz - a.nlz * a.lx),
            inv_stddev * (-a.nlx * a.ly + a.nly * a.lx),
        ], dim=-1)
        group = dict(w=w, r=r, jp=jp, jg=-inv_stddev, jd=None, ji=None,
                     jcf=None, cell=None)
        if optimize_intrinsics:
            cell = torch.where(valid, (a.py // cell_size) * wc + (a.px // cell_size), 0)
            raw_d = gather_nearest(raw_depth[s], a.px, a.py)
            # Guarded BEFORE the exponential: on invalid pixels raw_inv would
            # be ~1e12 and exp(-a/d) overflows once `a` goes negative.
            raw_ok = raw_d > 0
            raw_inv = 1.0 / torch.where(raw_ok, torch.clamp_min(raw_d, 1e-12), 1.0)
            cf = params.cfactor.reshape(-1)[cell]
            e = torch.exp(-params.a * raw_inv)
            ci = raw_inv + cf * e
            okd = valid & raw_ok & (torch.abs(ci) > 1e-4)
            safe_ci = torch.where(okd, ci, 1.0)
            dot = a.nlx * un_x + a.nly * un_y + a.nlz
            jac_base = torch.where(okd, inv_stddev * dot * e / (safe_ci * safe_ci), 0.0)
            j_cx = torch.where(okd, inv_stddev * a.pixel_depth * a.nlx, 0.0)
            j_cy = torch.where(okd, inv_stddev * a.pixel_depth * a.nly, 0.0)
            group.update(
                w=torch.where(okd, w, 0.0),
                ji=torch.stack([pxf * j_cx, pyf * j_cy, j_cx, j_cy,
                                cf * raw_inv * jac_base], dim=-1),
                jcf=-jac_base, cell=cell)
        groups.append(group)

    if use_descriptor:
        t1x, t1y, t2x, t2y, t_ok = tangent_projections(
            smap.pos, smap.normal, smap.radius2, ftg.q, ftg.t, cam)
        dvalid = valid & t_ok
        inten = kstack.intensity[s]
        ic, c_dx, c_dy = bilinear_and_gradient(inten, a.pxy_x, a.pxy_y)
        inv_z = 1.0 / torch.where(dvalid, a.lz, 1.0)
        inv_z_sq = inv_z * inv_z
        z_sq = a.lz * a.lz
        xy = a.lx * a.ly

        def desc_jp(gx_raw, gy_raw):
            gx = 180.0 * (gx_raw - c_dx) * cam.fx
            gy = 180.0 * (gy_raw - c_dy) * cam.fy
            return torch.stack([
                -gx * inv_z,
                -gy * inv_z,
                (a.lx * gx + a.ly * gy) * inv_z_sq,
                ((a.ly * a.ly + z_sq) * gy + xy * gx) * inv_z_sq,
                -((a.lx * a.lx + z_sq) * gx + xy * gy) * inv_z_sq,
                -(a.lx * gy - a.ly * gx) * inv_z,
            ], dim=-1)

        for slot, (tx, ty) in enumerate(((t1x, t1y), (t2x, t2y))):
            ik, dxk, dyk = bilinear_and_gradient(inten, tx, ty)
            r = torch.where(dvalid, 180.0 * (ik - ic) - smap.desc[:, slot], 0.0)
            w = torch.where(dvalid, robust.descriptor_residual_weight(r), 0.0)
            group = dict(w=w, r=r, jp=desc_jp(dxk, dyk), jg=None, jd=slot,
                         ji=None, jcf=None, cell=None)
            if optimize_intrinsics:
                # The photometric intrinsics Jacobian in the inverse
                # parametrization: dr/dfx_inv = -g_x * fx * px etc.
                gxr = 180.0 * (dxk - c_dx)
                gyr = 180.0 * (dyk - c_dy)
                group["ji"] = torch.stack([
                    -gxr * cam.fx * pxf, -gyr * cam.fy * pyf,
                    -gxr * cam.fx, -gyr * cam.fy, torch.zeros_like(gxr)], dim=-1)
            groups.append(group)
    return groups


class PCGSystem:
    """The Gauss-Newton system of one outer PCG iteration: the right-hand
    side b = -J^T W r, the diagonal M of J^T W J, and the matrix-free
    product `apply` with A = J^T W J (gauge-fixed). The keyframe batches
    are read once, when the system is built; `apply` reads nothing back."""

    def __init__(self, smap, cam, kstack: KeyframeStack, raw_depth=None,
                 params: DepthParams = None, baseline_fx: float = 40.0,
                 use_depth: bool = True, use_descriptor: bool = True,
                 gauge_kf: int = 0, cell_size: int = 4,
                 optimize_intrinsics: bool = False):
        device = smap.pos.device
        if params is None:
            params = DepthParams(a=torch.zeros((), device=device),
                                 cfactor=torch.zeros((1, 1), device=device))
        self.smap, self.cam, self.kstack = smap, cam, kstack
        self.raw_depth = kstack.depth if raw_depth is None else raw_depth
        self.params = params
        self.gauge_kf = gauge_kf
        self.optimize_intrinsics = optimize_intrinsics
        hc, wc = params.cfactor.shape
        self.sizes = (kstack.q.shape[0], smap.capacity, hc * wc)
        self.device = device
        self.batches = keyframe_batches(kstack.mask)
        self._coeff_kw = dict(
            baseline_fx=baseline_fx, use_depth=use_depth,
            use_descriptor=use_descriptor, params=params, cell_size=cell_size,
            wc=wc, optimize_intrinsics=optimize_intrinsics)

    def zeros(self) -> Unknowns:
        return _zeros_like_unknowns(*self.sizes, self.device)

    def coeffs(self, s) -> List[dict]:
        return _coeffs_for_keyframes(self.smap, self.cam, self.kstack,
                                     self.raw_depth, s, **self._coeff_kw)

    def gauge_fix(self, u: Unknowns) -> Unknowns:
        pose = u.pose.clone()
        pose[self.gauge_kf] = 0.0
        return u._replace(pose=pose)

    def rhs_and_diagonal(self):
        """(b, M): b = -J^T W r and M = diag(J^T W J), gauge-fixed b."""
        b, M = self.zeros(), self.zeros()
        for s in self.batches:
            bp = torch.zeros_like(b.pose[s])
            Mp = torch.zeros_like(M.pose[s])
            for g in self.coeffs(s):
                w = g["w"]
                wr = w * g["r"]
                bp -= torch.einsum("cnj,cn->cj", g["jp"], wr)
                Mp += torch.einsum("cn,cnj->cj", w, g["jp"] ** 2)
                if g["jg"] is not None:
                    b.geo.sub_((g["jg"] * wr).sum(dim=0))
                    M.geo.add_((w * g["jg"] ** 2).sum(dim=0))
                if g["jd"] is not None:
                    b.desc[:, g["jd"]] += wr.sum(dim=0)
                    M.desc[:, g["jd"]] += w.sum(dim=0)
                if g["ji"] is not None:
                    b.intr.sub_(torch.einsum("cni,cn->i", g["ji"], wr))
                    M.intr.add_(torch.einsum("cn,cni->i", w, g["ji"] ** 2))
                if g["jcf"] is not None:
                    flat = g["cell"].reshape(-1)
                    b.cfactor.index_add_(0, flat, (-g["jcf"] * wr).reshape(-1))
                    M.cfactor.index_add_(0, flat, (w * g["jcf"] ** 2).reshape(-1))
            b.pose[s] += bp
            M.pose[s] += Mp
        if self.optimize_intrinsics:
            # Weak zero-prior on `a` (kernel_opt_intrinsics.cc:154): residual
            # W * (a + x_a) -> b_a -= W^2 a, diag_a += W^2.
            w2 = A_PRIOR_WEIGHT * A_PRIOR_WEIGHT
            b.intr[4] -= w2 * self.params.a
            M.intr[4] += w2
        return self.gauge_fix(b), M

    def apply(self, p: Unknowns) -> Unknowns:
        """A p = J^T W J p, gauge-fixed."""
        p = self.gauge_fix(p)
        out = self.zeros()
        for s in self.batches:
            pk = p.pose[s]
            out_pose = torch.zeros_like(pk)
            for g in self.coeffs(s):
                v = torch.einsum("cnj,cj->cn", g["jp"], pk)
                if g["jg"] is not None:
                    v = v + g["jg"] * p.geo
                if g["jd"] is not None:
                    v = v + (-1.0) * p.desc[:, g["jd"]]
                if g["ji"] is not None:
                    v = v + torch.einsum("cni,i->cn", g["ji"], p.intr)
                if g["jcf"] is not None:
                    v = v + g["jcf"] * p.cfactor[g["cell"]]
                wv = g["w"] * v
                out_pose += torch.einsum("cnj,cn->cj", g["jp"], wv)
                if g["jg"] is not None:
                    out.geo.add_((g["jg"] * wv).sum(dim=0))
                if g["jd"] is not None:
                    out.desc[:, g["jd"]] -= wv.sum(dim=0)
                if g["ji"] is not None:
                    out.intr.add_(torch.einsum("cni,cn->i", g["ji"], wv))
                if g["jcf"] is not None:
                    out.cfactor.index_add_(0, g["cell"].reshape(-1),
                                           (g["jcf"] * wv).reshape(-1))
            out.pose[s] += out_pose
        if self.optimize_intrinsics:
            out.intr[4] += A_PRIOR_WEIGHT * A_PRIOR_WEIGHT * p.intr[4]
        return self.gauge_fix(out)


class PCGStepResult(NamedTuple):
    smap: object              # updated surfel map
    q: torch.Tensor           # [K, 4] updated global_T_frame rotations
    t: torch.Tensor           # [K, 3]
    cam: object               # updated camera (the input one without intrinsics)
    params: DepthParams       # updated depth parameters
    cg_steps: int             # CG steps taken


def _updated_camera(cam, dx: np.ndarray):
    """The additive update of the inverse parametrization, converted back
    to corner-convention intrinsics in float32, as the JAX package computes
    it on the device (kernel_opt_intrinsics.cc:184-196)."""
    f32 = np.float32
    fx, fy, cx, cy = (f32(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy))
    half = f32(0.5)
    fx_inv = f32(1.0) / fx + dx[0]
    fy_inv = f32(1.0) / fy + dx[1]
    cx_inv = -(cx - half) / fx + dx[2]
    cy_inv = -(cy - half) / fy + dx[3]
    fx_new = f32(1.0) / fx_inv
    fy_new = f32(1.0) / fy_inv
    return cam.with_intrinsics(fx=fx_new, fy=fy_new, cx=-(fx_new * cx_inv) + half,
                               cy=-(fy_new * cy_inv) + half)


def pcg_bundle_adjustment_step(
    smap, cam, kstack: KeyframeStack, raw_depth=None, params: DepthParams = None,
    baseline_fx: float = 40.0, use_depth: bool = True,
    use_descriptor: bool = True, max_inner_iterations: int = 30,
    gauge_kf: int = 0, cell_size: int = 4, optimize_intrinsics: bool = False,
) -> PCGStepResult:
    """One outer Gauss-Newton iteration solved by inner PCG."""
    system = PCGSystem(smap, cam, kstack, raw_depth, params, baseline_fx,
                       use_depth, use_descriptor, gauge_kf, cell_size,
                       optimize_intrinsics)
    params = system.params
    b, M = system.rhs_and_diagonal()
    M_inv = Unknowns(*(torch.where(m > 0, 1.0 / (m + DIAG_EPSILON), 0.0) for m in M))

    # PCGInit / Step1-3 (kernel_pcg.cu), x0 = 0.
    r = b
    z = _scale(M_inv, r)
    p = z
    rz = _dot(r, z)
    x = system.zeros()
    best = torch.full((), float("inf"), device=system.device)
    bad_steps = torch.zeros((), dtype=torch.int64, device=system.device)
    steps = 0
    # The stopping rule is tested before each step: at most
    # max_inner_iterations steps, 3 consecutive non-improving residual
    # norms (direct_ba_pcg.cc:440-456), rz above 1e-20; one read per step.
    while steps < max_inner_iterations and bool((bad_steps < 3) & (rz > 1e-20)):
        Ap = system.apply(p)
        pAp = _dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / torch.clamp_min(pAp, 1e-30), 0.0)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, Ap, r)
        z = _scale(M_inv, r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p = _axpy(beta, p, z)
        rnorm = torch.sqrt(rz_new)
        improved = rnorm < best
        bad_steps = torch.where(improved, 0, bad_steps + 1)
        best = torch.minimum(best, rnorm)
        rz = rz_new
        steps += 1
    x = system.gauge_fix(x)

    upd = (smap.valid & smap.active)[:, None]
    new_map = smap._replace(
        pos=smap.pos + torch.where(upd, x.geo[:, None] * smap.normal, 0.0),
        desc=smap.desc + torch.where(upd, x.desc, 0.0))
    moved = se3.mul(se3.SE3(kstack.q, kstack.t), se3.exp(x.pose))
    m = kstack.mask[:, None]
    new_q = torch.where(m, moved.q, kstack.q)
    new_t = torch.where(m, moved.t, kstack.t)

    new_cam = cam
    if optimize_intrinsics:
        new_cam = _updated_camera(cam, x.intr.cpu().numpy())
        params = DepthParams(
            a=params.a + x.intr[4],
            cfactor=params.cfactor + x.cfactor.reshape(params.cfactor.shape))
    return PCGStepResult(new_map, new_q, new_t, new_cam, params, steps)


def pcg_bundle_adjustment(direct_ba, max_iterations: int = 10,
                          max_inner_iterations: int = 30,
                          optimize_intrinsics: bool = False,
                          do_surfel_updates: bool = True) -> None:
    """The outer Gauss-Newton loop of PCG steps on a DirectBA
    (BundleAdjustmentPCG analog). Per outer iteration, as in the reference
    (direct_ba_pcg.cc:181-227): surfel creation for the keyframes (first
    iteration), surfel normal re-estimation, the PCG solve; the merge and
    compaction run after the last iteration, with no deletion and no new BA
    epoch. The gauge keyframe rotates with the iteration (the reference
    draws it at random, direct_ba_pcg.cc:318-337)."""
    ks = direct_ba.keyframes
    c = direct_ba.config
    if ks.count == 0:
        return
    slots = direct_ba._store_slots(ks.count)
    smap = direct_ba._working_map(ks.live_count if do_surfel_updates else 0)
    smap = smap._replace(active=smap.valid)
    for it in range(max_iterations):
        with direct_ba.pcg_spans.span(), record_function("ba/pcg_iteration"):
            kstack = ks.stack(ks.valid)
            if do_surfel_updates:
                if it == 0:
                    smap, _ = direct_ba._create_surfels(
                        smap, slots, kstack, slots.valid, direct_ba.min_observation_count(),
                        HOST)
                    # Creation appends after the compact prefix: every valid
                    # surfel now lies in [0, count).
                    smap = sf.prefix(smap, int(smap.count))
                smap = smap._replace(active=smap.valid)
                # Normals are not unknowns: re-estimate them per outer
                # iteration (UpdateSurfelNormalsCUDA, direct_ba_pcg.cc:215-227).
                smap = update_surfel_normals(smap, direct_ba.cam, kstack,
                                             baseline_fx=c.baseline_fx)
            result = pcg_bundle_adjustment_step(
                smap, direct_ba.cam, kstack, raw_depth=ks.stack_raw(),
                params=direct_ba.depth_params, baseline_fx=c.baseline_fx,
                use_depth=c.use_geometric_residuals,
                use_descriptor=c.use_photometric_residuals,
                max_inner_iterations=max_inner_iterations, gauge_kf=it % ks.count,
                cell_size=c.sparse_surfel_cell_size,
                optimize_intrinsics=optimize_intrinsics)
            smap = result.smap
            ks.set_poses(result.q, result.t, ks.valid)
            if optimize_intrinsics:
                direct_ba.cam = result.cam
                direct_ba.depth_params = result.params
                ks.recalibrate(direct_ba.cam, result.params.a, result.params.cfactor,
                               c.sparse_surfel_cell_size)
                direct_ba.intrinsics_updated = True
        direct_ba.cg_steps.append(result.cg_steps)
    if do_surfel_updates:
        # Scheme-end tasks of the PCG path: merge and compact.
        smap = sf.compact_surfels(direct_ba._merge_surfels(
            smap, slots, ks.stack(ks.valid), slots.valid, HOST))
    direct_ba.surfels = sf.write_back(direct_ba.surfels, smap)
    direct_ba.iterations_run.append(max_iterations)
