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
hands it the prefix [0, bucket) of the full map (``prefix`` and
``write_back``), the JAX package's pow-2 surfel bucket: entries beyond the
count are invalid, so the result is the same as on the whole capacity.

Operations over several keyframes visit them in fixed blocks of
``KEYFRAME_BATCH`` slots with the mask carried along (``static_blocks``;
[C, N] fields, one K2 launch per plane and block): a keyframe outside the
mask contributes exact zeros, as in the JAX package. Creation and merge
run once per set slot of their [K] mask, under a loop control
(``ops.conditional.for_each_slot``: the host loop over the set slots, the
masked plain version, or a WHILE node of a captured CUDA graph), and
write nothing with a host-dependent shape, so a BA call captures whole.
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
    free_space_violations,
    hits,
    tangent_projections,
)
from badslam_torch.mapping.keyframes import KeyframeStack, static_blocks
from badslam_torch.ops import robust
from badslam_torch.ops.conditional import HOST, Control, for_each_slot, pick
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
    """Copy a worked-on prefix back into the full map's storage, the count
    included, in place; returns `full`."""
    size = view.capacity
    for f in _ROW_FIELDS + ("count",):
        dst, src = getattr(full, f), getattr(view, f)
        if src.data_ptr() != dst.data_ptr() or src.shape != dst.shape:
            dst[:size].copy_(src) if dst.ndim else dst.copy_(src)
    return full


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
    # Every write is True (order-free); the rest go to a spare last entry.
    occ = torch.zeros(hc * wc + 1, dtype=torch.bool, device=depth.device)
    occ.scatter_(0, torch.where(hit, cell, hc * wc), True)
    return occ[: hc * wc].reshape(hc, wc)


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
                                merge_mask: torch.Tensor, baseline_fx: float,
                                cell_size: int, merge_dist_factor: float = 0.8,
                                loop: Control = HOST) -> SurfelMap:
    """The merge pass for each set slot of the [K] bool `merge_mask`, in
    slot order (the JAX package's scan with a cond per slot), under the
    loop control `loop`."""
    def step(state, i):
        return merge_surfels_for_frame(
            SurfelMap(*state), cam, pick(kstack.q, i), pick(kstack.t, i),
            pick(kstack.depth, i), pick(kstack.nx, i), pick(kstack.ny, i),
            baseline_fx, cell_size, merge_dist_factor)

    k = kstack.q.shape[0]
    return SurfelMap(*for_each_slot(loop, merge_mask[:k], smap, step, name="merge"))


# ---------------------------------------------------------------------------
# Surfel creation
# ---------------------------------------------------------------------------


def _rgb_planes(rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] u8 color -> [..., 3, H, W] f32, contiguous."""
    return rgb.movedim(-1, -3).to(torch.float32).contiguous()


class Candidates(NamedTuple):
    """One candidate surfel per sparsification cell of a keyframe."""

    valid: torch.Tensor    # [Hc*Wc] bool: a valid pixel in a free cell
    cx: torch.Tensor       # [Hc*Wc] the candidate pixel
    cy: torch.Tensor
    pos: torch.Tensor      # [Hc*Wc, 3] global position
    normal: torch.Tensor   # [Hc*Wc, 3] global normal
    radius2: torch.Tensor  # [Hc*Wc]


def surfel_candidates(cam, kf_q, kf_t, depth, f_nx, f_ny, radius2,
                      occupied: torch.Tensor, cell_size: int,
                      dtype=torch.float32) -> Candidates:
    """The lowest valid pixel of each cell that no surfel supports
    (`occupied`, [Hc*Wc] bool), unprojected to the world."""
    h, w = depth.shape
    hc, wc = h // cell_size, w // cell_size
    dev = depth.device
    ys = torch.arange(h, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, device=dev)[None, :].expand(h, w)
    flag = (depth > 0) & (xs >= 1) & (ys >= 1) & (xs < w - 1) & (ys < h - 1)
    pri = torch.where(flag, ys * w + xs, _BIG)
    best = (pri[: hc * cell_size, : wc * cell_size]
            .reshape(hc, cell_size, wc, cell_size).permute(0, 2, 1, 3)
            .reshape(hc * wc, cell_size * cell_size).amin(dim=-1))
    cand_valid = (best < _BIG) & ~occupied
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
    return Candidates(cand_valid, cx, cy, p_global, n_global,
                      gather_nearest(radius2, cx, cy))


def observation_counts(carry, cand: Candidates, b: KeyframeStack, cam,
                       baseline_fx: float):
    """Add the observations and free-space violations of the candidates in
    a batch of keyframes `b` to carry = (obs, fsv)."""
    obs, fsv = carry
    ftg = se3.inverse(se3.SE3(b.q, b.t))
    a = associate_surfels_with_frame(
        cam, cand.pos, cand.normal, cand.valid, ftg.q, ftg.t,
        b.depth, b.nx, b.ny, baseline_fx)
    return (obs + hits(a, b.mask).sum(dim=0),
            fsv + free_space_violations(a, b.mask).sum(dim=0))


def candidate_descriptors_and_colors(cam, kf_q, kf_t, cand: Candidates,
                                     intensity, rgb=None, dtype=torch.float32):
    """Descriptors from the tangent points in the keyframe itself, and the
    creation-time color: the keyframe's RGB at the candidate pixel, or gray
    from the intensity."""
    ftg_own = se3.inverse(se3.SE3(kf_q, kf_t))
    t1x, t1y, t2x, t2y, _ = tangent_projections(
        cand.pos, cand.normal, cand.radius2, ftg_own.q, ftg_own.t, cam)
    c_x = cand.cx.to(dtype) + 0.5
    c_y = cand.cy.to(dtype) + 0.5
    i_c = bilinear(intensity, c_x, c_y)
    desc = torch.stack([180.0 * (bilinear(intensity, t1x, t1y) - i_c),
                        180.0 * (bilinear(intensity, t2x, t2y) - i_c)], dim=-1)
    if rgb is not None:
        planes = _rgb_planes(rgb)
        color = torch.stack([bilinear(planes[ch], c_x, c_y) for ch in range(3)],
                            dim=-1)
    else:
        gray = 255.0 * i_c
        color = torch.stack([gray, gray, gray], dim=-1)
    return desc, color


def append_surfels(smap: SurfelMap, keep: torch.Tensor, cand: Candidates,
                   desc, color, limit: int, row0: int = 0):
    """Append the kept candidates after `count` (global rows, in candidate
    order); rows at or beyond `limit` are dropped. `smap` holds the global
    rows [row0, row0 + capacity): only those are written, and `count` is
    the global count. Returns (new map, number created).

    Each row takes its candidate by a search in the running count of the
    kept ones (the row's rank among the new surfels), so no tensor's shape
    depends on the data."""
    n = smap.capacity
    ranks = torch.cumsum(keep.to(torch.int64), dim=0)  # [M] kept so far
    dest = smap.count + ranks - 1
    created = (keep & (dest < limit)).sum()
    rank = torch.arange(row0, row0 + n, device=keep.device) - smap.count
    fill = (rank >= 0) & (rank < created)
    src = torch.clamp(torch.searchsorted(ranks, rank + 1), max=keep.shape[0] - 1)
    new = {}
    for name, values in (("pos", cand.pos), ("normal", cand.normal),
                         ("radius2", cand.radius2), ("color", color), ("desc", desc)):
        old = getattr(smap, name)
        f = fill.reshape((n,) + (1,) * (old.ndim - 1))
        new[name] = torch.where(f, values[src], old)
    for name in ("valid", "active"):  # new surfels start active
        new[name] = getattr(smap, name) | fill
    return SurfelMap(count=smap.count + created, **new), created


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
    occ = occupied_cells(smap, cam, kf_q, kf_t, depth, f_nx, f_ny,
                         baseline_fx, cell_size).reshape(-1)
    cand = surfel_candidates(cam, kf_q, kf_t, depth, f_nx, f_ny, radius2, occ,
                             cell_size, smap.pos.dtype)
    if filter_new_surfels:
        carry = (torch.ones_like(cand.cx), torch.zeros_like(cand.cx))  # self-observation
        for s in static_blocks(covis.q.shape[0]):
            carry = observation_counts(carry, cand, covis.rows(s), cam, baseline_fx)
        obs, fsv = carry
        keep = cand.valid & (obs >= min_observation_count) & (fsv <= obs)
    else:
        keep = cand.valid
    desc, color = candidate_descriptors_and_colors(cam, kf_q, kf_t, cand, intensity,
                                                   rgb, smap.pos.dtype)
    return append_surfels(smap, keep, cand, desc, color, smap.capacity)


def create_surfels_for_keyframes(
    smap: SurfelMap, cam, kstack: KeyframeStack, create_mask: torch.Tensor,
    covis_matrix, min_observation_count, baseline_fx: float, cell_size: int,
    filter_new_surfels: bool = True, rgb_stack=None, loop: Control = HOST,
) -> Tuple[SurfelMap, torch.Tensor]:
    """Create surfels for each set slot of the [K] bool `create_mask`, in
    slot order (the JAX package's scan with a cond per slot), under the
    loop control `loop`. The observation filter counts in the valid
    keyframes covisible with each one (kstack.mask is the valid mask);
    `min_observation_count` is an int or an integer scalar tensor."""
    k = kstack.q.shape[0]

    def step(state, i):
        covis = kstack._replace(mask=pick(covis_matrix, i)[:k] & kstack.mask)
        new_map, created = create_surfels_for_keyframe(
            SurfelMap(*state[:-1]), cam, pick(kstack.q, i), pick(kstack.t, i),
            pick(kstack.depth, i), pick(kstack.nx, i), pick(kstack.ny, i),
            pick(kstack.radius2, i), pick(kstack.intensity, i), covis,
            min_observation_count, baseline_fx, cell_size, filter_new_surfels,
            rgb=None if rgb_stack is None else pick(rgb_stack, i))
        return (*new_map, state[-1] + created)

    out = for_each_slot(loop, create_mask[:k], (*smap, smap.count.new_zeros(())), step,
                        name="create")
    return SurfelMap(*out[:-1]), out[-1]


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


def _delete_init(smap: SurfelMap):
    n = smap.capacity
    dev = smap.pos.device
    return (torch.zeros(n, dtype=torch.int64, device=dev),
            torch.zeros(n, dtype=torch.int64, device=dev),
            torch.full((n,), math.inf, dtype=smap.radius2.dtype, device=dev))


def _delete_chunk(carry, b: KeyframeStack, smap: SurfelMap, cam, baseline_fx):
    """One batch of keyframes: carry = (observations, free-space violations,
    smallest observed pixel radius^2) per surfel."""
    obs, fsv, min_r2 = carry
    ftg = se3.inverse(se3.SE3(b.q, b.t))
    a = _associate(smap, cam, ftg.q, ftg.t, b.depth, b.nx, b.ny, baseline_fx)
    hit = hits(a, b.mask)
    pr2 = gather_nearest(b.radius2, a.px, a.py)
    return (obs + hit.sum(dim=0), fsv + free_space_violations(a, b.mask).sum(dim=0),
            torch.minimum(min_r2, torch.where(hit, pr2, math.inf).amin(dim=0)))


def _delete_finish(smap: SurfelMap, carry, min_observation_count: int):
    """The surfels to delete and the new radii; returns (map, number
    deleted), the map's count lowered by that number."""
    obs, fsv, min_r2 = carry
    delete = smap.valid & ((obs < min_observation_count) | (fsv > obs))
    new_valid = smap.valid & ~delete
    deleted = delete.sum()
    return smap._replace(
        valid=new_valid,
        active=smap.active & new_valid,
        radius2=torch.where(new_valid & torch.isfinite(min_r2), min_r2,
                            smap.radius2),
        count=smap.count - deleted,
    ), deleted


def delete_surfels_and_update_radii(smap: SurfelMap, cam, kstack: KeyframeStack,
                                    min_observation_count: int,
                                    baseline_fx: float) -> SurfelMap:
    """Delete surfels observed by fewer than min_observation_count masked
    keyframes or with more free-space violations than observations; set the
    others' radius^2 to the smallest observed pixel radius^2
    (DeleteSurfelsAndUpdateRadiiCUDA, kernel_delete_surfels.cu)."""
    carry = _delete_init(smap)
    for s in static_blocks(kstack.q.shape[0]):
        carry = _delete_chunk(carry, kstack.rows(s), smap, cam, baseline_fx)
    return _delete_finish(smap, carry, min_observation_count)[0]


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
    for s in static_blocks(kstack.q.shape[0]):
        b = kstack.rows(s)
        ftg = se3.inverse(se3.SE3(b.q, b.t))
        a = _associate(smap, cam, ftg.q, ftg.t, b.depth, b.nx, b.ny, baseline_fx)
        hit = hits(a, b.mask)
        planes = _rgb_planes(rgb_stack[s])  # [C, 3, H, W]
        sample = torch.stack([bilinear(planes[:, ch], a.pxy_x, a.pxy_y)
                              for ch in range(3)], dim=-1)
        cnt = cnt + hit.to(dtype).sum(dim=0)
        acc = acc + torch.where(hit[..., None], sample, 0.0).sum(dim=0)
    observed = smap.valid & (cnt > 0)
    mean = acc / torch.clamp_min(cnt, 1.0)[:, None]
    return smap._replace(color=torch.where(observed[:, None], mean, smap.color))


def assign_descriptor_colors(smap: SurfelMap) -> SurfelMap:
    """Debug visualization: the two descriptor components as red and green
    with a contrast stretch (AssignDescriptorColorsCUDA,
    kernel_assign_colors.cu:233-258): d / 180 -> sign(d) |d|^0.35 ->
    255.99 (0.5 d + 0.5), clipped to [0, 255]; blue fixed at 127."""

    def stretch(d):
        d = d / 180.0
        d = torch.sign(d) * torch.abs(d) ** 0.35
        return torch.clamp(255.99 * (0.5 * d + 0.5), 0.0, 255.0)

    r = stretch(smap.desc[:, 0])
    g = stretch(smap.desc[:, 1])
    b = torch.full_like(r, 127.0)
    return smap._replace(color=torch.stack([r, g, b], dim=-1))
