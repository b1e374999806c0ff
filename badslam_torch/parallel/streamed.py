"""The alternating-BA stages over a device mesh: surfel rows sharded,
keyframe planes replicated or streamed.

Counterpart of ``badslam_tpu/parallel/streamed.py``. Each stage runs the
shards' work one shard after another from the one host thread, joined by
the collectives of ``parallel.mesh``; the planes of a keyframe batch come
from ``Planes.take``, a local read where the planes are replicated (the
integrated mode) and the broadcast from the owning shard where they are
streamed (K/D keyframes' planes per shard). One function per stage serves
both layouts.

  * creation and merge go keyframe by keyframe, the map updated in between
    (direct_ba.cc:340-405). Creation: occupancy is a psum-OR over the
    shards; the candidates are counted against each shard's own keyframes
    and the integer counts psummed; the append lands on the shard that owns
    the global destination row count + order. Merge: each cell slot's
    winner is the lowest global surfel id (pmin), whose attributes come
    back through a one-winner scatter and a psum.
  * activation + normals and position: every shard runs the chunk bodies
    of ba/geometry_opt.py over the same keyframe batches as the one-device
    stage, so its surfels' sums are those of the one-device stage.
  * delete accumulates per-surfel counters over the batches; compaction
    gathers the map, applies the global permutation and keeps each shard's
    rows; pose optimization gathers the map once and optimizes each
    keyframe on the shard that owns its slot.

Created surfels, merge winners, compaction order and delete counts depend
only on global ids and integer counts, so they are exact against the
one-device stages; so are all floats but the pose H/b of
`sharded.estimate_pose_sharded`, whose psum adds the shards' partial sums.
"""

from __future__ import annotations

from typing import List

import torch

from badslam_torch.ba import geometry_opt as geo
from badslam_torch.ba.pose_opt import PoseOptResult, optimize_keyframe_poses
from badslam_torch.geometry import se3
from badslam_torch.mapping import surfels as sf
from badslam_torch.mapping.keyframes import id_batches, index_of
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
from badslam_torch.ops import robust


def _ids(mask: torch.Tensor) -> List[int]:
    return torch.nonzero(mask).flatten().tolist()


# ---------------------------------------------------------------------------
# Surfel creation (keyframe by keyframe, the map updated in between)
# ---------------------------------------------------------------------------


def create_surfels_streamed(mesh: Mesh, smap: ShardedMap, cam, planes: Planes,
                            q, t, create_ids, covis, kf_valid,
                            min_observation_count: int, *, baseline_fx: float,
                            cell_size: int, filter_new_surfels: bool = True):
    """`sf.create_surfels_for_keyframes` over the mesh for the slots
    `create_ids` (host list, ascending). Returns (map, number created)."""
    k = q.shape[0]
    q_r, t_r = replicate(mesh, q), replicate(mesh, t)
    shards = list(smap.shards)
    dtype = shards[0].pos.dtype
    total = torch.zeros((), dtype=torch.int64, device=mesh.primary)
    for kf in create_ids:
        # The keyframe's planes on every shard; occupancy as a psum-OR.
        kfp, occ = [], []
        for i in range(mesh.size):
            with on_shard(i):
                p = {n: planes.take_kf(i, n, kf) for n in planes.blocks}
                kfp.append(p)
                occ.append(sf.occupied_cells(
                    shards[i], cam, q_r[i][kf], t_r[i][kf], p["depth"], p["nx"],
                    p["ny"], baseline_fx, cell_size).reshape(-1).to(torch.int64))
        occ = psum(mesh, occ)

        cands, obs, fsv = [], [], []
        if filter_new_surfels:
            observers = _ids(covis[kf, :k] & kf_valid[:k])
        for i in range(mesh.size):
            with on_shard(i):
                p = kfp[i]
                cand = sf.surfel_candidates(
                    cam, q_r[i][kf], t_r[i][kf], p["depth"], p["nx"], p["ny"],
                    p["radius2"], occ[i] > 0, cell_size, dtype)
                cands.append(cand)
                if filter_new_surfels:
                    # Candidates against this shard's own keyframes.
                    lo, hi = planes.owned(i)
                    carry = (torch.zeros_like(cand.cx), torch.zeros_like(cand.cx))
                    for b in id_batches(j for j in observers if lo <= j < hi):
                        carry = sf.observation_counts(
                            carry, cand, planes.batch(i, b, q_r[i], t_r[i],
                                                      ("depth", "nx", "ny")),
                            cam, baseline_fx)
                    obs.append(carry[0])
                    fsv.append(carry[1])
        if filter_new_surfels:
            obs, fsv = psum(mesh, obs), psum(mesh, fsv)

        for i in range(mesh.size):
            with on_shard(i):
                cand = cands[i]
                keep = cand.valid
                if filter_new_surfels:
                    o = obs[i] + 1  # self-observation
                    keep = keep & (o >= min_observation_count) & (fsv[i] <= o)
                desc, color = sf.candidate_descriptors_and_colors(
                    cam, q_r[i][kf], t_r[i][kf], cand, kfp[i]["intensity"],
                    kfp[i].get("rgb"), dtype)
                shards[i], created = sf.append_surfels(
                    shards[i], keep, cand, desc, color, smap.rows, i * smap.block)
                if i == 0:
                    total = total + created.to(total.device)
    return smap._replace(shards=tuple(shards)), total


# ---------------------------------------------------------------------------
# Activation + normals, then position, over the keyframe batches
# ---------------------------------------------------------------------------


def activation_geometry_streamed(mesh: Mesh, smap: ShardedMap, cam,
                                 planes: Planes, q, t, active_strict,
                                 participating, *, baseline_fx: float,
                                 use_depth: bool, use_descriptor: bool,
                                 optimize_geometry: bool) -> ShardedMap:
    """`geo.update_activation_and_normals` and, with `optimize_geometry`,
    `geo._position_step` over the participating keyframes."""
    visit = participating | active_strict if optimize_geometry else active_strict
    batches = id_batches(_ids(visit))
    pos_batches = id_batches(_ids(participating)) if optimize_geometry else []
    pos_names = ("depth", "nx", "ny") + (("intensity",) if use_descriptor else ())
    q_r, t_r = replicate(mesh, q), replicate(mesh, t)
    am_r, pm_r = replicate(mesh, active_strict), replicate(mesh, participating)
    out = []
    for i, dev in enumerate(mesh.devices):
        with on_shard(i):
            s = smap.shards[i]
            carry = geo._act_normals_init(s)
            for b in batches:
                idx = index_of(b, dev)
                carry = geo._act_normals_chunk(
                    carry, planes.batch(i, b, q_r[i], t_r[i], ("depth", "nx", "ny")),
                    am_r[i][idx], pm_r[i][idx], s, cam, baseline_fx,
                    optimize_geometry)
            s = geo._act_normals_finish(s, carry, optimize_geometry)
            if optimize_geometry:
                carry = geo._pos_init(s, use_descriptor)
                for b in pos_batches:
                    carry = geo._pos_chunk(
                        carry, planes.batch(i, b, q_r[i], t_r[i], pos_names), s,
                        cam, baseline_fx, use_depth, use_descriptor)
                s = geo._pos_finish(s, carry, use_descriptor)
            out.append(s)
    return smap._replace(shards=tuple(out))


# ---------------------------------------------------------------------------
# Merge (keyframe by keyframe; cell winners through pmin + psum)
# ---------------------------------------------------------------------------


def merge_surfels_streamed(mesh: Mesh, smap: ShardedMap, cam, planes: Planes,
                           q, t, merge_ids, *, baseline_fx: float, cell_size: int,
                           merge_dist_factor: float = 0.8) -> ShardedMap:
    """`sf.merge_surfels_for_keyframes` over the mesh for the slots
    `merge_ids` (host list, ascending)."""
    q_r, t_r = replicate(mesh, q), replicate(mesh, t)
    h, w = cam.height, cam.width
    hc, wc = h // cell_size, w // cell_size
    cell_merge_dist_sq = (cell_size * merge_dist_factor) ** 2
    nl = smap.block
    shards = list(smap.shards)
    for kf in merge_ids:
        cells, remaining, gids, valid = [], [], [], []
        for i, dev in enumerate(mesh.devices):
            with on_shard(i):
                s = shards[i]
                ftg = se3.inverse(se3.SE3(q_r[i][kf], t_r[i][kf]))
                a = sf._associate(s, cam, ftg.q, ftg.t, planes.take_kf(i, "depth", kf),
                                  planes.take_kf(i, "nx", kf), planes.take_kf(i, "ny", kf),
                                  baseline_fx)
                cell, rem = sf._cells(a, cell_size, hc, wc)
                cells.append(torch.where(rem, cell, 0))
                remaining.append(rem)
                gids.append(i * nl + torch.arange(nl, device=dev))
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
            # radius2) scattered into a zero table and psummed.
            tabs, my = [], []
            for i, dev in enumerate(mesh.devices):
                s = shards[i]
                my_winner = win[i][cells[i]]
                is_winner = remaining[i] & (my_winner == gids[i])
                my.append(my_winner)
                tab = torch.zeros((hc * wc, 7), dtype=s.pos.dtype, device=dev)
                attrs = torch.cat([s.normal, s.pos, s.radius2[:, None]], dim=-1)
                tab[cells[i][is_winner]] = attrs[is_winner]
                tabs.append(tab)
            tabs = psum(mesh, tabs)
            for i in range(mesh.size):
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
        shards = [s._replace(valid=v, active=s.active & v, count=s.count - d)
                  for s, v, d in zip(shards, valid, deleted)]
    return smap._replace(shards=tuple(shards))


# ---------------------------------------------------------------------------
# Delete + radii, compaction
# ---------------------------------------------------------------------------


def delete_surfels_streamed(mesh: Mesh, smap: ShardedMap, cam, planes: Planes,
                            q, t, kf_mask, min_observation_count: int, *,
                            baseline_fx: float) -> ShardedMap:
    """`sf.delete_surfels_and_update_radii` over the keyframes of
    `kf_mask`; the deleted counts are psummed into the global count."""
    batches = id_batches(_ids(kf_mask))
    q_r, t_r = replicate(mesh, q), replicate(mesh, t)
    out, deleted = [], []
    for i in range(mesh.size):
        with on_shard(i):
            s = smap.shards[i]
            carry = sf._delete_init(s)
            for b in batches:
                carry = sf._delete_chunk(
                    carry, planes.batch(i, b, q_r[i], t_r[i],
                                        ("depth", "nx", "ny", "radius2")),
                    s, cam, baseline_fx)
            s, d = sf._delete_finish(s, carry, min_observation_count)
            out.append(s)
            deleted.append(d)
    deleted = psum(mesh, deleted)
    return smap._replace(shards=tuple(s._replace(count=old.count - d)
                                      for s, old, d in zip(out, smap.shards, deleted)))


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
# Pose optimization (each keyframe on the shard that owns its slot)
# ---------------------------------------------------------------------------


def optimize_poses_streamed(mesh: Mesh, smap: ShardedMap, cam, planes: Planes,
                            q, t, participating, *, baseline_fx: float,
                            use_depth: bool, use_descriptor: bool,
                            max_iterations: int = 30) -> PoseOptResult:
    """`optimize_keyframe_poses` for the [K] keyframes q, t, participating:
    the map is gathered once per device, and shard i optimizes the
    participating keyframes of the slots it owns against it. The result is
    on q's device."""
    k = q.shape[0]
    maps = gathered_maps(mesh, smap)
    q_r, t_r, m_r = (replicate(mesh, x) for x in (q, t, participating))
    q_out, t_out = q.clone(), t.clone()
    moved = torch.zeros(k, dtype=torch.bool, device=q.device)
    for i in range(mesh.size):
        lo, hi = planes.owned(i)
        hi = min(hi, k)
        if lo >= hi:
            continue
        with on_shard(i):
            r = optimize_keyframe_poses(
                maps[i], cam, planes.local_stack(i, q_r[i], t_r[i], m_r[i], k),
                baseline_fx, use_depth, use_descriptor, max_iterations)
        q_out[lo:hi] = r.q.to(q.device)
        t_out[lo:hi] = r.t.to(q.device)
        moved[lo:hi] = r.moved.to(q.device)
    return PoseOptResult(q=q_out, t=t_out, moved=moved)
