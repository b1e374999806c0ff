"""Surfel map as a structure of arrays, and the map operations.

Counterpart of ``badslam_tpu/mapping/surfels.py`` (the reference's surfel
buffer and its maintenance kernels: kernel_create_surfels.cu,
kernel_supporting_surfels.cu, kernel_delete_surfels.cu,
kernel_compact_surfels.cu, kernel_surfel_activation.cu,
kernel_assign_colors.cu). As there:

  * holes are a `valid` mask;
  * the reference's atomicCAS cell and slot races are deterministic
    "lowest surfel index wins" scatter-mins (``scatter_reduce_`` with
    ``amin`` on int64, exact and order-free on the CPU and on CUDA), so the
    map is the same from run to run and equal to the JAX package's;
  * compaction is a stable cumsum permutation: survivors keep their order.

Every operation works on whatever capacity the map it is given has. BA
hands it the prefix [0, count + room) of the full map (``prefix`` and
``write_back``): entries beyond are invalid, so the result is the same as
on the whole capacity.

Operations over several keyframes visit the keyframes of their mask in
batches of up to ``KEYFRAME_BATCH`` ([C, N] fields, one K2 launch per
plane and batch); keyframes outside the mask contribute exact zeros in the
JAX package, so skipping them changes only the order of float sums.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from badslam_torch.geometry import se3
from badslam_torch.geometry.linalg import rotate3, transform3
from badslam_torch.mapping.association import (
    Association,
    associate_surfels_with_frame,
    tangent_projections,
)
from badslam_torch.mapping.keyframes import KeyframeStack, keyframe_batches
from badslam_torch.ops import robust
from badslam_torch.ops.interp import bilinear, gather_nearest
from badslam_torch.ops.preprocess import normal_z

_BIG = 2**30  # neutral value of the scatter-mins (surfels.py:48 there)
MERGE_SLOT_COUNT = 3  # kMergeBufferCount (kernels.cuh:51)


class SurfelMap(NamedTuple):
    pos: torch.Tensor      # [N, 3] f32 global positions
    normal: torch.Tensor   # [N, 3] f32 global unit normals
    radius2: torch.Tensor  # [N] f32 squared radii
    color: torch.Tensor    # [N, 3] f32 RGB in [0, 255]
    desc: torch.Tensor     # [N, 2] f32 descriptor components
    valid: torch.Tensor    # [N] bool
    active: torch.Tensor   # [N] bool (kSurfelActiveFlag analog)
    count: torch.Tensor    # [] int64 number of valid surfels

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


_ROW_FIELDS = ("pos", "normal", "radius2", "color", "desc", "valid", "active")


def empty_map(capacity: int, device: torch.device | str) -> SurfelMap:
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SurfelMap(pos=z(capacity, 3), normal=z(capacity, 3),
                     radius2=z(capacity), color=z(capacity, 3),
                     desc=z(capacity, 2),
                     valid=z(capacity, dtype=torch.bool),
                     active=z(capacity, dtype=torch.bool),
                     count=z(dtype=torch.int64))


def prefix(smap: SurfelMap, size: int) -> SurfelMap:
    """The first `size` entries (views of the same storage)."""
    return smap._replace(**{f: getattr(smap, f)[:size] for f in _ROW_FIELDS})


def write_back(full: SurfelMap, view: SurfelMap) -> SurfelMap:
    """Copy a worked-on prefix back into the full map, in place."""
    size = view.capacity
    for f in _ROW_FIELDS:
        dst, src = getattr(full, f), getattr(view, f)
        if src.data_ptr() != dst.data_ptr() or src.shape != dst.shape:
            dst[:size].copy_(src)
    return full._replace(count=view.count)


def _associate(smap: SurfelMap, cam, frame_q, frame_t, depth, f_nx, f_ny,
               baseline_fx, mask=None) -> Association:
    return associate_surfels_with_frame(
        cam, smap.pos, smap.normal, smap.valid if mask is None else mask,
        frame_q, frame_t, depth, f_nx, f_ny, baseline_fx)


# ---------------------------------------------------------------------------
# Supporting surfels + merge
# ---------------------------------------------------------------------------


def _cells(assoc: Association, cell_size: int, hc: int, wc: int):
    """(cell index, in-grid mask) of each associated surfel."""
    cell = (assoc.py // cell_size) * wc + (assoc.px // cell_size)
    return cell, assoc.valid & (cell < hc * wc)


def occupied_cells(smap: SurfelMap, cam, kf_q, kf_t, depth, f_nx, f_ny,
                   baseline_fx: float, cell_size: int) -> torch.Tensor:
    """[Hc, Wc] bool: cells of the keyframe (global_T_frame pose) with at
    least one associated surfel (DetermineSupportingSurfelsCUDA,
    kernel_supporting_surfels.cu:40-100)."""
    h, w = depth.shape
    hc, wc = h // cell_size, w // cell_size
    ftg = se3.inverse(se3.SE3(kf_q, kf_t))
    assoc = _associate(smap, cam, ftg.q, ftg.t, depth, f_nx, f_ny, baseline_fx)
    cell, hit = _cells(assoc, cell_size, hc, wc)
    occ = torch.zeros(hc * wc, dtype=torch.bool, device=depth.device)
    occ[cell[hit]] = True  # every write is True: order-free
    return occ.reshape(hc, wc)


def merge_surfels_for_frame(smap: SurfelMap, cam, kf_q, kf_t, depth, f_nx,
                            f_ny, baseline_fx: float, cell_size: int,
                            merge_dist_factor: float = 0.8) -> SurfelMap:
    """Merge surfels that land in the same sparsification cell of a
    keyframe (DetermineSupportingSurfelsAndMergeSurfelsCUDA): for each of
    the 3 cell slots the lowest-index remaining surfel claims it; the
    others in the cell are deleted if their normal agrees and they lie
    closer than merge_dist_factor * cell_size * min radius."""
    h, w = depth.shape
    hc, wc = h // cell_size, w // cell_size
    ftg = se3.inverse(se3.SE3(kf_q, kf_t))
    assoc = _associate(smap, cam, ftg.q, ftg.t, depth, f_nx, f_ny, baseline_fx)
    cell, remaining = _cells(assoc, cell_size, hc, wc)
    cell = torch.where(remaining, cell, 0)
    n = smap.capacity
    idx = torch.arange(n, device=depth.device)
    cell_merge_dist_sq = (cell_size * merge_dist_factor) ** 2

    valid = smap.valid
    for _ in range(MERGE_SLOT_COUNT):
        winner = torch.full((hc * wc,), _BIG, dtype=torch.int64, device=depth.device)
        winner.scatter_reduce_(0, cell, torch.where(remaining, idx, _BIG),
                               reduce="amin", include_self=True)
        my_winner = winner[cell]
        is_winner = remaining & (my_winner == idx)
        loser = remaining & ~is_winner & (my_winner < _BIG)
        wi = torch.clamp(my_winner, 0, n - 1)
        normal_agree = (torch.sum(smap.normal * smap.normal[wi], dim=-1)
                        > robust.COS_NORMAL_COMPATIBILITY_THRESHOLD)
        dist_sq = torch.sum((smap.pos - smap.pos[wi]) ** 2, dim=-1)
        min_r2 = torch.minimum(smap.radius2, smap.radius2[wi])
        merged = loser & normal_agree & (dist_sq < min_r2 * cell_merge_dist_sq)
        valid = valid & ~merged
        remaining = loser & ~merged  # survivors compete for the next slot

    deleted = torch.sum(smap.valid & ~valid)
    return smap._replace(valid=valid, active=smap.active & valid,
                         count=smap.count - deleted)


def merge_surfels_for_keyframes(smap: SurfelMap, cam, kstack: KeyframeStack,
                                merge_ids, baseline_fx: float, cell_size: int,
                                merge_dist_factor: float = 0.8) -> SurfelMap:
    """The merge pass for each keyframe slot in `merge_ids` (host list, in
    slot order, as the JAX package's masked scan)."""
    for i in merge_ids:
        smap = merge_surfels_for_frame(
            smap, cam, kstack.q[i], kstack.t[i], kstack.depth[i], kstack.nx[i],
            kstack.ny[i], baseline_fx, cell_size, merge_dist_factor)
    return smap


# ---------------------------------------------------------------------------
# Surfel creation
# ---------------------------------------------------------------------------


def _rgb_planes(rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] u8 color -> [..., 3, H, W] f32, contiguous."""
    return rgb.movedim(-1, -3).to(torch.float32).contiguous()


def create_surfels_for_keyframe(
    smap: SurfelMap, cam,
    kf_q, kf_t,                          # global_T_frame of the keyframe
    depth, f_nx, f_ny, radius2, intensity,  # its planes [H, W]
    covis: KeyframeStack,                # keyframes to count observations in
    min_observation_count: int,
    baseline_fx: float,
    cell_size: int,
    filter_new_surfels: bool = True,
    rgb=None,                            # optional [H, W, 3] u8 color plane
) -> Tuple[SurfelMap, torch.Tensor]:
    """Create surfels for the cells of a keyframe that no surfel supports
    (DirectBA::CreateSurfelsForKeyframe, direct_ba.cc:340-405): one
    candidate pixel per cell (the lowest pixel index), kept when enough
    covisible keyframes observe it without a free-space violation.
    Returns (new map, number created)."""
    h, w = depth.shape
    hc, wc = h // cell_size, w // cell_size
    n = smap.capacity
    dev = depth.device
    dtype = smap.pos.dtype

    occ = occupied_cells(smap, cam, kf_q, kf_t, depth, f_nx, f_ny,
                         baseline_fx, cell_size).reshape(-1)

    ys = torch.arange(h, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, device=dev)[None, :].expand(h, w)
    flag = (depth > 0) & (xs >= 1) & (ys >= 1) & (xs < w - 1) & (ys < h - 1)
    pri = torch.where(flag, ys * w + xs, _BIG)
    best = (pri[: hc * cell_size, : wc * cell_size]
            .reshape(hc, cell_size, wc, cell_size).permute(0, 2, 1, 3)
            .reshape(hc * wc, cell_size * cell_size).amin(dim=-1))
    cand_valid = (best < _BIG) & ~occ
    best = torch.where(cand_valid, best, 0)
    cy = best // w
    cx = best - cy * w

    c_depth = gather_nearest(depth, cx, cy)
    un_x = cam.fx_inv * cx.to(dtype) + cam.cx_inv
    un_y = cam.fy_inv * cy.to(dtype) + cam.cy_inv
    p_local = torch.stack([c_depth * un_x, c_depth * un_y, c_depth], dim=-1)
    R_g = se3.quat_to_matrix(kf_q)
    p_global = transform3(R_g, kf_t, p_local)
    c_nx = gather_nearest(f_nx, cx, cy)
    c_ny = gather_nearest(f_ny, cx, cy)
    n_global = rotate3(R_g, torch.stack([c_nx, c_ny, normal_z(c_nx, c_ny)], dim=-1))
    c_radius2 = gather_nearest(radius2, cx, cy)

    if filter_new_surfels:
        obs = torch.ones_like(best)  # self-observation
        fsv = torch.zeros_like(best)
        for s in keyframe_batches(covis.mask):
            ftg = se3.inverse(se3.SE3(covis.q[s], covis.t[s]))
            a = associate_surfels_with_frame(
                cam, p_global, n_global, cand_valid, ftg.q, ftg.t,
                covis.depth[s], covis.nx[s], covis.ny[s], baseline_fx)
            obs = obs + a.valid.sum(dim=0)
            fsv = fsv + a.free_space_violation.sum(dim=0)
        keep = cand_valid & (obs >= min_observation_count) & (fsv <= obs)
    else:
        keep = cand_valid

    # Descriptors from the tangent points in the keyframe itself.
    ftg_own = se3.inverse(se3.SE3(kf_q, kf_t))
    t1x, t1y, t2x, t2y, _ = tangent_projections(
        p_global, n_global, c_radius2, ftg_own.q, ftg_own.t, cam)
    c_x = cx.to(dtype) + 0.5
    c_y = cy.to(dtype) + 0.5
    i_c = bilinear(intensity, c_x, c_y)
    desc = torch.stack([180.0 * (bilinear(intensity, t1x, t1y) - i_c),
                        180.0 * (bilinear(intensity, t2x, t2y) - i_c)], dim=-1)

    # Creation-time color: the keyframe's RGB at the candidate pixel, or
    # gray from the intensity.
    if rgb is not None:
        planes = _rgb_planes(rgb)
        color = torch.stack([bilinear(planes[ch], c_x, c_y) for ch in range(3)],
                            dim=-1)
    else:
        gray = 255.0 * i_c
        color = torch.stack([gray, gray, gray], dim=-1)

    # Append after `count`; candidates beyond the capacity are dropped.
    dest = smap.count + torch.cumsum(keep.to(torch.int64), dim=0) - 1
    ok = keep & (dest < n)
    dest = dest[ok]
    new = {}
    for name, values in (("pos", p_global), ("normal", n_global),
                         ("radius2", c_radius2), ("color", color), ("desc", desc)):
        arr = getattr(smap, name).clone()
        arr[dest] = values[ok]
        new[name] = arr
    for name in ("valid", "active"):  # new surfels start active
        arr = getattr(smap, name).clone()
        arr[dest] = True
        new[name] = arr
    created = ok.sum()
    return SurfelMap(count=smap.count + created, **new), created


def create_surfels_for_keyframes(
    smap: SurfelMap, cam, kstack: KeyframeStack, create_ids, covis_matrix,
    min_observation_count: int, baseline_fx: float, cell_size: int,
    filter_new_surfels: bool = True, rgb_stack=None,
) -> Tuple[SurfelMap, torch.Tensor]:
    """Create surfels for each keyframe slot in `create_ids` (host list, in
    slot order). The observation filter counts in the valid keyframes
    covisible with each one (kstack.mask is the valid mask)."""
    total = smap.count.new_zeros(())
    for i in create_ids:
        covis = kstack._replace(mask=covis_matrix[i, : kstack.q.shape[0]] & kstack.mask)
        smap, created = create_surfels_for_keyframe(
            smap, cam, kstack.q[i], kstack.t[i], kstack.depth[i], kstack.nx[i],
            kstack.ny[i], kstack.radius2[i], kstack.intensity[i], covis,
            min_observation_count, baseline_fx, cell_size, filter_new_surfels,
            rgb=None if rgb_stack is None else rgb_stack[i])
        total = total + created
    return smap, total


# ---------------------------------------------------------------------------
# Activation, deletion, compaction, colors
# ---------------------------------------------------------------------------


def update_surfel_activation(smap: SurfelMap, cam, kstack: KeyframeStack,
                             baseline_fx: float) -> SurfelMap:
    """A surfel is active iff it is associated with any keyframe of
    `kstack.mask` (UpdateSurfelActivationCUDA,
    kernel_surfel_activation.cu:38-96)."""
    from badslam_torch.ba.geometry_opt import update_activation_and_normals

    return update_activation_and_normals(
        smap, cam, kstack, kstack.mask, kstack.mask, baseline_fx,
        update_normals=False)


def delete_surfels_and_update_radii(smap: SurfelMap, cam, kstack: KeyframeStack,
                                    min_observation_count: int,
                                    baseline_fx: float) -> SurfelMap:
    """Delete surfels observed by fewer than min_observation_count masked
    keyframes or with more free-space violations than observations; set the
    others' radius^2 to the smallest observed pixel radius^2
    (DeleteSurfelsAndUpdateRadiiCUDA, kernel_delete_surfels.cu)."""
    n = smap.capacity
    dev = smap.pos.device
    obs = torch.zeros(n, dtype=torch.int64, device=dev)
    fsv = torch.zeros(n, dtype=torch.int64, device=dev)
    min_r2 = torch.full((n,), math.inf, dtype=smap.radius2.dtype, device=dev)
    for s in keyframe_batches(kstack.mask):
        ftg = se3.inverse(se3.SE3(kstack.q[s], kstack.t[s]))
        a = _associate(smap, cam, ftg.q, ftg.t, kstack.depth[s], kstack.nx[s],
                       kstack.ny[s], baseline_fx)
        hit = a.valid
        obs = obs + hit.sum(dim=0)
        fsv = fsv + a.free_space_violation.sum(dim=0)
        pr2 = gather_nearest(kstack.radius2[s], a.px, a.py)
        min_r2 = torch.minimum(min_r2, torch.where(hit, pr2, math.inf).amin(dim=0))
    delete = smap.valid & ((obs < min_observation_count) | (fsv > obs))
    new_valid = smap.valid & ~delete
    return smap._replace(
        valid=new_valid,
        active=smap.active & new_valid,
        radius2=torch.where(new_valid & torch.isfinite(min_r2), min_r2,
                            smap.radius2),
        count=smap.count - delete.sum(),
    )


def compact_surfels(smap: SurfelMap) -> SurfelMap:
    """Pack the valid surfels into the prefix [0, count), keeping their
    order (CompactSurfelsCUDA analog; a stable cumsum permutation)."""
    v = smap.valid
    rank_valid = torch.cumsum(v.to(torch.int64), dim=0) - 1
    rank_invalid = torch.cumsum((~v).to(torch.int64), dim=0) - 1
    dest = torch.where(v, rank_valid, smap.count + rank_invalid)

    def permute(arr):
        out = torch.zeros_like(arr)
        out[dest] = arr
        return out

    return smap._replace(**{f: permute(getattr(smap, f)) for f in _ROW_FIELDS})


def assign_colors(smap: SurfelMap, cam, kstack: KeyframeStack,
                  rgb_stack: torch.Tensor, baseline_fx: float) -> SurfelMap:
    """Average each surfel's color over every masked keyframe pixel it is
    associated with, sampled bilinearly at the projection (AssignColorsCUDA,
    kernel_assign_colors.cu:73-131). Unobserved surfels keep their color."""
    n = smap.capacity
    dtype = smap.color.dtype
    cnt = torch.zeros(n, dtype=dtype, device=smap.pos.device)
    acc = torch.zeros((n, 3), dtype=dtype, device=smap.pos.device)
    for s in keyframe_batches(kstack.mask):
        ftg = se3.inverse(se3.SE3(kstack.q[s], kstack.t[s]))
        a = _associate(smap, cam, ftg.q, ftg.t, kstack.depth[s], kstack.nx[s],
                       kstack.ny[s], baseline_fx)
        hit = a.valid
        planes = _rgb_planes(rgb_stack[s])  # [C, 3, H, W]
        sample = torch.stack([bilinear(planes[:, ch], a.pxy_x, a.pxy_y)
                              for ch in range(3)], dim=-1)
        cnt = cnt + hit.to(dtype).sum(dim=0)
        acc = acc + torch.where(hit[..., None], sample, 0.0).sum(dim=0)
    observed = smap.valid & (cnt > 0)
    mean = acc / torch.clamp_min(cnt, 1.0)[:, None]
    return smap._replace(color=torch.where(observed[:, None], mean, smap.color))
