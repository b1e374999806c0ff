"""The alternating-BA stages over a device mesh: surfel rows sharded,
keyframe planes replicated or streamed.

Counterpart of ``badslam_tpu/parallel/streamed.py``. Each stage runs the
shards' work one shard after another from the one host thread, joined by
the collectives of ``parallel.mesh``; the planes of keyframe slots come
from ``Planes.take``, a local read where the planes are replicated (the
integrated mode) and the broadcast from the owning shard where they are
streamed (K/D keyframes' planes per shard). One function per stage serves
both layouts.

A stage works on a call's keyframes: q, t and the masks are [K] rows, and
``slots`` (an int64 tensor, default [0, K)) holds the store slot of each
row, whose planes ``Planes`` reads (the keyframe bucket of a replicated
call: row r is slot ``slots[r]``). No stage reads a value back to the host:
which keyframes take part is a device mask, and every loop runs under a
loop control (``control``: ``ops.conditional``'s HOST, MASKED, or a
``DeviceControl`` inside a CUDA-graph capture), as in the one-device
stages.

  * creation and merge go keyframe by keyframe over the set slots of their
    mask (``for_each_slot``), the map updated in between
    (direct_ba.cc:340-405). Creation: occupancy is a psum-OR over the
    shards; the candidates are counted against the observers (the mask
    ``covis[k] & valid``) that each shard owns, read from its own planes,
    and the integer counts psummed; the append lands on the shard that
    owns the global destination row count + order. Merge: each cell slot's
    winner is the lowest global surfel id (pmin), whose attributes come
    back through a one-winner scatter and a psum.
  * activation + normals, position and delete: every shard runs the chunk
    bodies of ba/geometry_opt.py and mapping/surfels.py over the same fixed
    blocks of ``KEYFRAME_BATCH`` rows as the one-device stage, with the
    mask carried along, so its surfels' sums are those of the one-device
    stage on the same rows.
  * compaction gathers the map, applies the global permutation and keeps
    each shard's rows; pose optimization gathers the map once and runs the
    Gauss-Newton loop of each block of the rows a shard owns (from the
    layout, host-known) under the control.

Created surfels, merge winners, compaction order and delete counts depend
only on global ids and integer counts, so they are exact against the
one-device stages; so are all floats but the pose H/b of
`sharded.estimate_pose_sharded`, whose psum adds the shards' partial sums.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from badslam_torch.ba import geometry_opt as geo
from badslam_torch.ba.pose_opt import PoseOptResult, optimize_keyframe_poses
from badslam_torch.geometry import se3
from badslam_torch.mapping import surfels as sf
from badslam_torch.mapping.keyframes import static_blocks
from badslam_torch.mapping.surfels import SurfelMap
from badslam_torch.ops import robust
from badslam_torch.ops.conditional import HOST, Control, for_each_slot, pick
from badslam_torch.parallel.mesh import (
    Mesh,
    Planes,
    ShardedMap,
    gathered_maps,
    on_shard,
    pmin,
    psum,
    replicate,
    split_rows,
)

_FIELDS = len(SurfelMap._fields)


def flat(smap: ShardedMap) -> tuple:
    """The shards' tensors in one tuple (a loop's state)."""
    return tuple(x for s in smap.shards for x in s)


def unflat(smap: ShardedMap, state: Sequence[torch.Tensor]) -> ShardedMap:
    """The ShardedMap of `flat`'s tuple (the rows and layout of `smap`)."""
    return smap._replace(shards=tuple(
        SurfelMap(*state[i * _FIELDS:(i + 1) * _FIELDS]) for i in range(len(smap.shards))))


def _slots(slots: Optional[torch.Tensor], k: int, device) -> torch.Tensor:
    return torch.arange(k, device=device) if slots is None else slots[:k]


def _per_shard(mesh: Mesh, x):
    """A tensor replicated to the shards, or a host value as it is."""
    return replicate(mesh, x) if isinstance(x, torch.Tensor) else [x] * mesh.size


def _slot(slots: torch.Tensor, k) -> torch.Tensor:
    """Row k's slot as a [1] index tensor, for a host int or a device
    scalar k."""
    return pick(slots, k).reshape(1)


# ---------------------------------------------------------------------------
# Surfel creation (keyframe by keyframe, the map updated in between)
# ---------------------------------------------------------------------------


def create_surfels_streamed(mesh: Mesh, smap: ShardedMap, cam, planes: Planes,
                            q, t, create_mask, covis, kf_valid, min_observation_count,
                            *, baseline_fx: float, cell_size: int,
                            filter_new_surfels: bool = True,
                            slots: Optional[torch.Tensor] = None,
                            control: Control = HOST):
    """`sf.create_surfels_for_keyframes` over the mesh for each set row of
    the [K] bool `create_mask`, in row order, under the loop control
    `control`; `covis` ([K, K]) and `kf_valid` ([K]) pick each one's
    observers, `min_observation_count` is an int or an integer scalar
    tensor. Returns (map, number created as an int64 scalar tensor)."""
    k = q.shape[0]
    d = mesh.size
    ids = _slots(slots, k, q.device)
    q_r, t_r, ids_r = replicate(mesh, q), replicate(mesh, t), replicate(mesh, ids)
    mobs = _per_shard(mesh, min_observation_count)
    dtype = smap.shards[0].pos.dtype
    owned = [planes.owned(i, k) for i in range(d)]

    def step(state, kf):
        shards = unflat(smap, state[:-1]).shards
        slot = _slot(ids, kf)
        kfp = {n: planes.take_kf(n, slot) for n in planes.blocks}
        qk = [pick(x, kf) for x in q_r]
        tk = [pick(x, kf) for x in t_r]
        # Occupancy as a psum-OR over the shards.
        occ = []
        for i in range(d):
            with on_shard(i):
                occ.append(sf.occupied_cells(
                    shards[i], cam, qk[i], tk[i], kfp["depth"][i], kfp["nx"][i],
                    kfp["ny"][i], baseline_fx, cell_size).reshape(-1).to(torch.int64))
        occ = psum(mesh, occ)

        cands, obs, fsv = [], [], []
        if filter_new_surfels:
            observers = replicate(mesh, pick(covis, kf)[:k] & kf_valid[:k])
        for i in range(d):
            with on_shard(i):
                cand = sf.surfel_candidates(
                    cam, qk[i], tk[i], kfp["depth"][i], kfp["nx"][i], kfp["ny"][i],
                    kfp["radius2"][i], occ[i] > 0, cell_size, dtype)
                cands.append(cand)
                if filter_new_surfels:
                    # Candidates against the observers this shard owns.
                    lo, hi = owned[i]
                    carry = (torch.zeros_like(cand.cx), torch.zeros_like(cand.cx))
                    for s in static_blocks(hi - lo):
                        r = slice(lo + s.start, lo + s.stop)
                        carry = sf.observation_counts(
                            carry, cand, planes.local_stack(
                                i, ids_r[i][r], q_r[i][r], t_r[i][r], observers[i][r],
                                ("depth", "nx", "ny")),
                            cam, baseline_fx)
                    obs.append(carry[0])
                    fsv.append(carry[1])
        if filter_new_surfels:
            obs, fsv = psum(mesh, obs), psum(mesh, fsv)

        out, created = [], []
        for i in range(d):
            with on_shard(i):
                cand = cands[i]
                keep = cand.valid
                if filter_new_surfels:
                    o = obs[i] + 1  # self-observation
                    keep = keep & (o >= mobs[i]) & (fsv[i] <= o)
                desc, color = sf.candidate_descriptors_and_colors(
                    cam, qk[i], tk[i], cand, kfp["intensity"][i], kfp["rgb"][i], dtype)
                s, c = sf.append_surfels(shards[i], keep, cand, desc, color, smap.rows,
                                         i * smap.block)
                out.append(s)
                created.append(c)  # the same number on every shard
        return (*flat(smap._replace(shards=tuple(out))),
                state[-1] + created[0].to(state[-1].device))

    total = torch.zeros((), dtype=torch.int64, device=mesh.primary)
    state = for_each_slot(control, create_mask[:k], (*flat(smap), total), step,
                          name="create")
    return unflat(smap, state[:-1]), state[-1]


# ---------------------------------------------------------------------------
# Activation + normals, then position, over fixed keyframe blocks
# ---------------------------------------------------------------------------


def activation_geometry_streamed(mesh: Mesh, smap: ShardedMap, cam,
                                 planes: Planes, q, t, active_strict,
                                 participating, *, baseline_fx: float,
                                 use_depth: bool, use_descriptor: bool,
                                 optimize_geometry: bool,
                                 slots: Optional[torch.Tensor] = None) -> ShardedMap:
    """`geo.update_activation_and_normals` and, with `optimize_geometry`,
    `geo._position_step` over the participating keyframes."""
    d = mesh.size
    ids = _slots(slots, q.shape[0], q.device)
    q_r, t_r = replicate(mesh, q), replicate(mesh, t)
    am_r, pm_r = replicate(mesh, active_strict), replicate(mesh, participating)
    shards = list(smap.shards)
    carry = [geo._act_normals_init(s) for s in shards]
    for s, stacks in planes.blocks_of(ids, q_r, t_r, pm_r, ("depth", "nx", "ny")):
        for i in range(d):
            with on_shard(i):
                carry[i] = geo._act_normals_chunk(
                    carry[i], stacks[i], am_r[i][s], pm_r[i][s], shards[i], cam,
                    baseline_fx, optimize_geometry)
    shards = [geo._act_normals_finish(s, c, optimize_geometry)
              for s, c in zip(shards, carry)]
    if optimize_geometry:
        pos_names = ("depth", "nx", "ny") + (("intensity",) if use_descriptor else ())
        carry = [geo._pos_init(s, use_descriptor) for s in shards]
        for _, stacks in planes.blocks_of(ids, q_r, t_r, pm_r, pos_names):
            for i in range(d):
                with on_shard(i):
                    carry[i] = geo._pos_chunk(carry[i], stacks[i], shards[i], cam,
                                              baseline_fx, use_depth, use_descriptor)
        shards = [geo._pos_finish(s, c, use_descriptor) for s, c in zip(shards, carry)]
    return smap._replace(shards=tuple(shards))


# ---------------------------------------------------------------------------
# Merge (keyframe by keyframe; cell winners through pmin + psum)
# ---------------------------------------------------------------------------


def merge_surfels_streamed(mesh: Mesh, smap: ShardedMap, cam, planes: Planes,
                           q, t, merge_mask, *, baseline_fx: float, cell_size: int,
                           merge_dist_factor: float = 0.8,
                           slots: Optional[torch.Tensor] = None,
                           control: Control = HOST) -> ShardedMap:
    """`sf.merge_surfels_for_keyframes` over the mesh for each set row of
    the [K] bool `merge_mask`, in row order, under the loop control
    `control`."""
    k = q.shape[0]
    d = mesh.size
    ids = _slots(slots, k, q.device)
    q_r, t_r = replicate(mesh, q), replicate(mesh, t)
    h, w = cam.height, cam.width
    hc, wc = h // cell_size, w // cell_size
    cell_merge_dist_sq = (cell_size * merge_dist_factor) ** 2
    nl = smap.block
    gids = [i * nl + torch.arange(nl, device=dev) for i, dev in enumerate(mesh.devices)]

    def step(state, kf):
        shards = unflat(smap, state).shards
        slot = _slot(ids, kf)
        depth, nx, ny = (planes.take_kf(n, slot) for n in ("depth", "nx", "ny"))
        cells, remaining, valid = [], [], []
        for i in range(d):
            with on_shard(i):
                s = shards[i]
                ftg = se3.inverse(se3.SE3(pick(q_r[i], kf), pick(t_r[i], kf)))
                a = sf._associate(s, cam, ftg.q, ftg.t, depth[i], nx[i], ny[i],
                                  baseline_fx)
                cell, rem = sf._cells(a, cell_size, hc, wc)
                cells.append(torch.where(rem, cell, 0))
                remaining.append(rem)
                valid.append(s.valid)
        for _ in range(sf.MERGE_SLOT_COUNT):
            win = []
            for i, dev in enumerate(mesh.devices):
                wl = torch.full((hc * wc,), sf._BIG, dtype=torch.int64, device=dev)
                wl.scatter_reduce_(0, cells[i],
                                   torch.where(remaining[i], gids[i], sf._BIG),
                                   reduce="amin", include_self=True)
                win.append(wl)
            win = pmin(mesh, win)
            # Each cell has one winner on the whole mesh: its (normal, pos,
            # radius2) copied into a zero table (the others into a spare
            # last row) and psummed.
            tabs, my = [], []
            for i, dev in enumerate(mesh.devices):
                s = shards[i]
                my_winner = win[i][cells[i]]
                is_winner = remaining[i] & (my_winner == gids[i])
                my.append(my_winner)
                tab = torch.zeros((hc * wc + 1, 7), dtype=s.pos.dtype, device=dev)
                attrs = torch.cat([s.normal, s.pos, s.radius2[:, None]], dim=-1)
                tab.index_copy_(0, torch.where(is_winner, cells[i], hc * wc), attrs)
                tabs.append(tab[:hc * wc])
            tabs = psum(mesh, tabs)
            for i in range(d):
                s = shards[i]
                is_winner = remaining[i] & (my[i] == gids[i])
                loser = remaining[i] & ~is_winner & (my[i] < sf._BIG)
                watt = tabs[i][cells[i]]
                normal_agree = (torch.sum(s.normal * watt[:, 0:3], dim=-1)
                                > robust.COS_NORMAL_COMPATIBILITY_THRESHOLD)
                dist_sq = torch.sum((s.pos - watt[:, 3:6]) ** 2, dim=-1)
                min_r2 = torch.minimum(s.radius2, watt[:, 6])
                merged = loser & normal_agree & (dist_sq < min_r2 * cell_merge_dist_sq)
                valid[i] = valid[i] & ~merged
                remaining[i] = loser & ~merged  # survivors compete for the next slot
        deleted = psum(mesh, [(s.valid & ~v).sum() for s, v in zip(shards, valid)])
        return flat(smap._replace(shards=tuple(
            s._replace(valid=v, active=s.active & v, count=s.count - n)
            for s, v, n in zip(shards, valid, deleted))))

    return unflat(smap, for_each_slot(control, merge_mask[:k], flat(smap), step,
                                      name="merge"))


# ---------------------------------------------------------------------------
# Delete + radii, compaction
# ---------------------------------------------------------------------------


def delete_surfels_streamed(mesh: Mesh, smap: ShardedMap, cam, planes: Planes,
                            q, t, kf_mask, min_observation_count, *,
                            baseline_fx: float,
                            slots: Optional[torch.Tensor] = None) -> ShardedMap:
    """`sf.delete_surfels_and_update_radii` over the keyframes of
    `kf_mask`; the deleted counts are psummed into the global count."""
    d = mesh.size
    ids = _slots(slots, q.shape[0], q.device)
    q_r, t_r, m_r = (replicate(mesh, x) for x in (q, t, kf_mask[:q.shape[0]]))
    carry = [sf._delete_init(s) for s in smap.shards]
    for _, stacks in planes.blocks_of(ids, q_r, t_r, m_r,
                             ("depth", "nx", "ny", "radius2")):
        for i in range(d):
            with on_shard(i):
                carry[i] = sf._delete_chunk(carry[i], stacks[i], smap.shards[i], cam,
                                            baseline_fx)
    out, deleted = zip(*(sf._delete_finish(s, c, m) for s, c, m in zip(
        smap.shards, carry, _per_shard(mesh, min_observation_count))))
    deleted = psum(mesh, list(deleted))
    return smap._replace(shards=tuple(s._replace(count=old.count - n)
                                      for s, old, n in zip(out, smap.shards, deleted)))


def compact_surfels_streamed(mesh: Mesh, smap: ShardedMap) -> ShardedMap:
    """Global compaction: the map gathered on each device, the global
    permutation applied, each shard keeping its own rows."""
    full = {}
    for dev, m in zip(mesh.devices, gathered_maps(mesh, smap)):
        if dev not in full:
            full[dev] = sf.compact_surfels(m)
    return smap._replace(shards=tuple(
        split_rows(full[dev], smap.block, i) for i, dev in enumerate(mesh.devices)))


# ---------------------------------------------------------------------------
# Pose optimization (each keyframe on the shard that owns its row)
# ---------------------------------------------------------------------------


def optimize_poses_streamed(mesh: Mesh, smap: ShardedMap, cam, planes: Planes,
                            q, t, participating, *, baseline_fx: float,
                            use_depth: bool, use_descriptor: bool,
                            max_iterations: int = 30,
                            slots: Optional[torch.Tensor] = None,
                            control: Control = HOST) -> PoseOptResult:
    """`optimize_keyframe_poses` for the [K] keyframes q, t, participating:
    the map is gathered once per device, and shard i optimizes the
    participating keyframes of the rows it owns (``Planes.owned``) against
    it, each block's Gauss-Newton loop under the loop control `control`.
    The result is on q's device."""
    k = q.shape[0]
    ids = _slots(slots, k, q.device)
    maps = gathered_maps(mesh, smap)
    q_r, t_r, m_r, ids_r = (replicate(mesh, x) for x in (q, t, participating[:k], ids))
    parts: List[PoseOptResult] = []
    for i in range(mesh.size):
        lo, hi = planes.owned(i, k)
        if lo >= hi:
            continue
        r = slice(lo, hi)
        with on_shard(i):
            res = optimize_keyframe_poses(
                maps[i], cam, planes.local_stack(i, ids_r[i][r], q_r[i][r], t_r[i][r],
                                                 m_r[i][r]),
                baseline_fx, use_depth, use_descriptor, max_iterations, loop=control)
        parts.append(res)
    return PoseOptResult(*(torch.cat([getattr(p, f).to(q.device) for p in parts])
                           for f in PoseOptResult._fields))
