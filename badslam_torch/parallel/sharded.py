"""BA stages with one axis split over a device mesh, on global inputs.

Counterpart of ``badslam_tpu/parallel/sharded.py``. Each function takes
the global map and keyframes (on any device), splits the axis it
parallelizes over the mesh, runs the one-device stage on every shard and
returns the global result on the map's (or the poses') device:

  * pose optimization is independent per keyframe given the map
    (direct_ba_alternating.cc:543-577): the keyframe axis is split, the
    map replicated, no collectives;
  * geometry optimization is independent per surfel given the poses: the
    surfel axis is split, the planes replicated (``optimize_geometry_sharded``)
    or split over the keyframe axis and broadcast batch by batch from their
    owners (``optimize_geometry_plane_streamed``); the count stays global;
  * one pose's Gauss-Newton sums a 6x6 system over all surfels: each shard
    accumulates its surfels' H/b, a psum adds them in shard order, and the
    solve is done once on the summed system.
"""

from __future__ import annotations

import torch

from badslam_torch.ba import geometry_opt as geo
from badslam_torch.ba.pose_opt import (
    PoseOptResult,
    is_scale1_converged,
    optimize_keyframe_poses,
    surfel_pose_coeffs,
)
from badslam_torch.geometry import se3
from badslam_torch.geometry.linalg import solve_psd
from badslam_torch.mapping.keyframes import KeyframeStack
from badslam_torch.mapping.surfels import SurfelMap
from badslam_torch.parallel.mesh import (
    Mesh,
    Planes,
    gather_rows,
    on_shard,
    psum,
    replicate,
    shard_rows,
)


def _replicated_stack(mesh: Mesh, kstack: KeyframeStack):
    per_field = [replicate(mesh, x) for x in kstack]
    return [KeyframeStack(*(f[i] for f in per_field)) for i in range(mesh.size)]


def optimize_keyframe_poses_sharded(mesh: Mesh, smap: SurfelMap, cam,
                                    kstack: KeyframeStack,
                                    baseline_fx: float = 40.0,
                                    use_depth: bool = True,
                                    use_descriptor: bool = True,
                                    max_iterations: int = 30) -> PoseOptResult:
    """Pose optimization with the keyframe axis split into D blocks
    (K % D == 0) against the replicated map."""
    k = kstack.q.shape[0]
    if k % mesh.size:
        raise ValueError(f"{k} keyframes do not divide over {mesh.size} shards")
    kl = k // mesh.size
    fields = [replicate(mesh, x) for x in smap]
    parts = []
    for i, dev in enumerate(mesh.devices):
        rows = slice(i * kl, (i + 1) * kl)
        with on_shard(i):
            parts.append(optimize_keyframe_poses(
                SurfelMap(*(f[i] for f in fields)), cam,
                KeyframeStack(*(x[rows].to(dev) for x in kstack)), baseline_fx,
                use_depth, use_descriptor, max_iterations))
    dev = kstack.q.device
    return PoseOptResult(*(torch.cat([getattr(p, f).to(dev) for p in parts])
                           for f in PoseOptResult._fields))


def optimize_geometry_sharded(mesh: Mesh, smap: SurfelMap, cam,
                              kstack: KeyframeStack, baseline_fx: float = 40.0,
                              use_depth: bool = True,
                              use_descriptor: bool = True) -> SurfelMap:
    """`geo.optimize_geometry_iteration` with the surfel axis split and the
    planes replicated."""
    sm = shard_rows(mesh, smap)
    stacks = _replicated_stack(mesh, kstack)
    out = []
    for i in range(mesh.size):
        with on_shard(i):
            out.append(geo.optimize_geometry_iteration(
                sm.shards[i], cam, stacks[i], baseline_fx, use_depth, use_descriptor))
    return gather_rows(mesh, sm._replace(shards=tuple(out)), smap.pos.device)


def optimize_geometry_plane_streamed(mesh: Mesh, smap: SurfelMap, cam,
                                     kstack: KeyframeStack,
                                     baseline_fx: float = 40.0,
                                     use_depth: bool = True,
                                     use_descriptor: bool = True) -> SurfelMap:
    """`geo.optimize_geometry_iteration` with the surfel axis split and the
    planes split over the keyframe axis (K % D == 0): nothing big is
    replicated. Each batch of the masked keyframes is broadcast from its
    owners, in the one-device stage's fixed blocks with the mask carried."""
    planes = Planes(mesh, {"depth": kstack.depth, "nx": kstack.nx, "ny": kstack.ny,
                           "intensity": kstack.intensity}, streamed=True)
    ids = torch.arange(kstack.q.shape[0], device=kstack.q.device)
    pos_names = ("depth", "nx", "ny") + (("intensity",) if use_descriptor else ())
    sm = shard_rows(mesh, smap)
    q_r, t_r, m_r = (replicate(mesh, x) for x in (kstack.q, kstack.t, kstack.mask))
    shards = list(sm.shards)
    carry = [geo._act_normals_init(s)[1:] for s in shards]
    for _, stacks in planes.blocks_of(ids, q_r, t_r, m_r, ("depth", "nx", "ny")):
        for i in range(mesh.size):
            with on_shard(i):
                carry[i] = geo._normals_chunk(carry[i], stacks[i], shards[i], cam,
                                              baseline_fx)
    shards = [geo._normals_finish(s, c) for s, c in zip(shards, carry)]
    carry = [geo._pos_init(s, use_descriptor) for s in shards]
    for _, stacks in planes.blocks_of(ids, q_r, t_r, m_r, pos_names):
        for i in range(mesh.size):
            with on_shard(i):
                carry[i] = geo._pos_chunk(carry[i], stacks[i], shards[i], cam, baseline_fx,
                                          use_depth, use_descriptor)
    out = [geo._pos_finish(s, c, use_descriptor) for s, c in zip(shards, carry)]
    return gather_rows(mesh, sm._replace(shards=tuple(out)), smap.pos.device)


def estimate_pose_sharded(mesh: Mesh, smap: SurfelMap, cam, kf_q, kf_t, depth,
                          f_nx, f_ny, intensity, baseline_fx: float = 40.0,
                          use_depth: bool = True, use_descriptor: bool = True,
                          max_iterations: int = 30):
    """One keyframe's pose Gauss-Newton with the surfel axis split: each
    shard accumulates H/b over its surfels, the psum adds them, and one
    solve updates the pose. The loop ends after `max_iterations` steps or
    at the first converged step (one host read per step, as the tracker's).
    Returns (q, t) on kf_q's device."""
    sm = shard_rows(mesh, smap)
    planes = [replicate(mesh, x) for x in (depth, f_nx, f_ny, intensity)]
    q, t = kf_q, kf_t
    eye = torch.eye(6, dtype=torch.float32, device=mesh.primary)
    for _ in range(max_iterations):
        parts = []
        for i, dev in enumerate(mesh.devices):
            with on_shard(i):
                parts.append(surfel_pose_coeffs(
                    sm.shards[i], cam, q.to(dev), t.to(dev),
                    *(p[i] for p in planes), baseline_fx, use_depth, use_descriptor))
        H, b, count = (psum(mesh, [p[j] for p in parts])[0] for j in range(3))
        ok = count > 6
        x = solve_psd(torch.where(ok, H, eye), b)
        x = torch.where(ok & torch.all(torch.isfinite(x)), x, 0.0)
        upd = se3.mul(se3.SE3(q.to(x.device), t.to(x.device)), se3.exp(-x))
        q, t = upd.q.to(kf_q.device), upd.t.to(kf_q.device)
        if bool(is_scale1_converged(x)):
            break
    return q, t
