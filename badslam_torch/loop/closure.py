"""Loop-closure application: the refinements, the gates, the pose graph and
the trajectory deformation, with no host read.

Counterpart of ``badslam_tpu/loop/closure_device.py`` (the reference's
loop_detector.cc:436-705) and of the JAX front end's attempt
(``badslam_tpu/frontend.py:987-1080``):

  * three direct refinements of cur_T_matched, one against the matched
    keyframe and one against each temporal neighbour (loop_detector.cc:
    436-548), each a run of the frame tracker from RANSAC's pose;
  * consistency gate: at least 2 valid refinements, and every pair of them
    within 10 degrees of viewing direction and 2 cm (loop_detector.cc:
    556-604);
  * the average of the valid refinements (AveragePose, util.h:46);
  * necessity gate: the mean keypoint pixel motion the closure implies must
    exceed 1 px, or fewer than 5 keypoints project (loop_detector.cc:
    624-666);
  * pose-graph Gauss-Newton over the live keyframes in temporal order
    (``pose_graph.optimize_pose_graph_device``) with the loop edge weighted
    by the gates, then the deformation of the whole trajectory against the
    pre-closure keyframe poses;
  * a device closure counter incremented by the gates.

As in the JAX package, every decision is a device mask: the gated write
``torch.where(ok, new, old)`` goes in place into the keyframe store's poses
and the trajectory buffers, so a rejected candidate leaves every pose
bit-identical, and nothing is read back. The host supplies only value-free
metadata (``ClosureInputs``): the live keyframe order padded to a power of
two, the slots, RANSAC's pose, the detector's keypoints padded to its
capacity and the deformation brackets. The JAX package pads the order
with repeats of its first slot and scatters the duplicates, so which value
of vertex 0 wins is undefined there (closure_device.py:134-139); here the
padded positions scatter into a sentinel row past the store and are
dropped, so a padded attempt equals the unpadded one.

``attempt_closure`` is the whole attempt as one function of tensors: on the
CPU (and on a card with ``BadSlam.closure_graph = None``) the front end
calls it eagerly, on a card ``loop.graph.ClosureGraph`` captures it as one
CUDA graph and replays it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from badslam_torch.geometry import se3
from badslam_torch.loop.pose_graph import optimize_pose_graph_device
from badslam_torch.loop.trajectory import deform_trajectory
from badslam_torch.ops.conditional import HOST, Control, pick
from badslam_torch.ops.pyramid import build_pyramid
from badslam_torch.tracking.pairwise import track_frame_pairwise

MAX_ANGLE_DIFFERENCE = math.pi / 180.0 * 10.0  # loop_detector.cc:577
MAX_EUCLIDEAN_DISTANCE = 0.02                  # loop_detector.cc:578
AVERAGE_PIXEL_DISTANCE_THRESHOLD = 1.0         # loop_detector.cc:661
# The refinement slots of an attempt (the matched keyframe and its two
# temporal neighbours); fewer are padded with ref_valid false.
REFINEMENT_SLOTS = 3


def _consistency_ok(ref_q: torch.Tensor, ref_t: torch.Tensor,
                    ref_valid: torch.Tensor) -> torch.Tensor:
    """All valid refinement pairs within the angle and translation gates,
    and at least 2 valid refinements. [] bool."""
    z = se3.quat_to_matrix(ref_q)[..., :, 2]          # [M, 3] view directions
    cosang = torch.clamp(z @ z.T, -1.0, 1.0)
    ang_ok = torch.arccos(cosang) <= MAX_ANGLE_DIFFERENCE
    d = torch.linalg.vector_norm(ref_t[:, None, :] - ref_t[None, :, :], dim=-1)
    dist_ok = d <= MAX_EUCLIDEAN_DISTANCE
    pair_valid = ref_valid[:, None] & ref_valid[None, :]
    ok = torch.all(torch.where(pair_valid, ang_ok & dist_ok, True))
    return ok & (ref_valid.sum() >= 2)


def _average_pose(ref_q: torch.Tensor, ref_t: torch.Tensor,
                  ref_valid: torch.Tensor) -> se3.SE3:
    """Masked AveragePose: mean translation and normalized mean quaternion,
    hemispheres aligned to the first valid entry."""
    w = ref_valid.to(torch.float32)
    n = torch.clamp_min(w.sum(), 1.0)
    t = (ref_t * w[:, None]).sum(0) / n
    q0 = pick(ref_q, torch.argmax(ref_valid.to(torch.int32)))
    sign = torch.where(ref_q @ q0 >= 0, 1.0, -1.0)
    q = (ref_q * (sign * w)[:, None]).sum(0)
    return se3.SE3(se3.quat_normalize(q), t)


def _closure_needed(cam, pts: torch.Tensor, pts_valid: torch.Tensor,
                    cur_T_global_estimate: se3.SE3,
                    global_T_cur_actual: se3.SE3) -> torch.Tensor:
    """Mean keypoint pixel motion over 1 px, or fewer than 5 projectable
    keypoints. [] bool."""
    delta = se3.mul(cur_T_global_estimate, global_T_cur_actual)
    moved = se3.quat_rotate(delta.q, pts) + delta.t

    def project(p):
        z = torch.clamp_min(p[:, 2], 1e-9)
        x = cam.fx * p[:, 0] / z + cam.cx
        y = cam.fy * p[:, 1] / z + cam.cy
        ok = (p[:, 2] > 0) & (x >= 0) & (y >= 0) & (x < cam.width) & (y < cam.height)
        return torch.stack([x, y], -1), ok

    pe, oke = project(moved)
    pc, okc = project(pts)
    ok = oke & okc & pts_valid
    cnt = ok.sum()
    dist = torch.linalg.vector_norm(pe - pc, dim=-1)
    avg = torch.where(ok, dist, 0.0).sum() / torch.clamp_min(cnt, 1)
    return (cnt < 5) | (avg > AVERAGE_PIXEL_DISTANCE_THRESHOLD)


class ClosureResult(NamedTuple):
    """The gates' outcomes, [] bool tensors on the poses' device."""
    consistent: torch.Tensor
    needed: torch.Tensor

    @property
    def ok(self) -> torch.Tensor:
        return self.consistent & self.needed


def apply_closure(
    kq: torch.Tensor, kt: torch.Tensor,   # [K, 4/3] keyframe store poses (written in place)
    order: torch.Tensor,                  # [B] live slots in temporal order, padded
    n_live,                               # live entries of `order` (int or [] tensor)
    cur_pos, matched_pos,                 # positions in `order` (int or [] tensor)
    ref_q: torch.Tensor, ref_t: torch.Tensor,  # [M, 4/3] refined cur_T_matched
    ref_valid: torch.Tensor,              # [M] bool
    pts: torch.Tensor,                    # [N, 3] current keyframe's keypoints (camera frame)
    pts_valid: torch.Tensor,              # [N] bool
    traj_q: torch.Tensor, traj_t: torch.Tensor,  # [F, 4/3] trajectory (written in place)
    prev_slot, next_slot, alpha, kf_slot,  # [F] deformation brackets
    count: torch.Tensor,                  # [] int64 closure counter (incremented in place)
    cam,
    graph_iterations: int = 20,
) -> ClosureResult:
    """Gates, the pose graph over the ordered live keyframes with the loop
    edge weighted by the gates, and the trajectory deformation; the store's
    poses, the trajectory and the counter are updated in place where both
    gates passed and left bit-identical where not (closure_device.py:
    100-145). Reads nothing back."""
    cur_T_matched = _average_pose(ref_q, ref_t, ref_valid)
    consistent = _consistency_ok(ref_q, ref_t, ref_valid)
    oq, ot = kq[order], kt[order]
    x_cur = se3.SE3(pick(oq, cur_pos), pick(ot, cur_pos))
    x_matched = se3.SE3(pick(oq, matched_pos), pick(ot, matched_pos))
    cur_T_global_est = se3.mul(cur_T_matched, se3.inverse(x_matched))
    needed = _closure_needed(cam, pts, pts_valid, cur_T_global_est, x_cur)
    ok = consistent & needed

    # Loop edge Z = X_matched^-1 X_cur = matched_T_cur.
    z = se3.inverse(cur_T_matched)
    new_oq, new_ot = optimize_pose_graph_device(
        oq, ot, n_live, matched_pos, cur_pos, z.q, z.t,
        loop_weight=ok.to(torch.float32), iterations=graph_iterations)
    # The live positions scatter into their slots; the padded ones into a
    # sentinel row past the store, which is dropped.
    k = kq.shape[0]
    live = torch.arange(order.shape[0], device=order.device) < n_live
    rows = torch.where(live, order, k)
    kq2 = torch.cat([kq, kq[:1]]).index_copy_(0, rows, new_oq)[:k]
    kt2 = torch.cat([kt, kt[:1]]).index_copy_(0, rows, new_ot)[:k]
    new_traj_q, new_traj_t = deform_trajectory(traj_q, traj_t, kq, kt, kq2, kt2,
                                               prev_slot, next_slot, alpha, kf_slot)
    traj_q.copy_(torch.where(ok, new_traj_q, traj_q))
    traj_t.copy_(torch.where(ok, new_traj_t, traj_t))
    kq.copy_(torch.where(ok, kq2, kq))
    kt.copy_(torch.where(ok, kt2, kt))
    count.add_(ok.to(count.dtype))
    return ClosureResult(consistent, needed)


class ClosureKey(NamedTuple):
    """The configuration an attempt depends on."""
    num_scales: int
    use_gradmag: bool
    baseline_fx: float
    use_depth: bool
    use_descriptor: bool
    max_iterations: int
    refinements: int  # refinements run: 2 or 3


class ClosureInputs(NamedTuple):
    """An attempt's value-free metadata: numpy arrays on the host (from
    ``make_inputs``), tensors on the device (``upload``)."""
    order: object      # [B] int64 live slots in temporal order, padded with order[0]
    n_live: object     # [] int64
    cur_pos: object    # [] int64 the current keyframe's position in `order`
    matched_pos: object  # [] int64 the matched keyframe's position
    cur_slot: object   # [] int64 the current keyframe's slot
    ref_slots: object  # [3] int64 the refinements' keyframe slots
    init_q: object     # [4] f32 RANSAC's cur_T_matched
    init_t: object     # [3] f32
    pts: object        # [P, 3] f32 the current keyframe's keypoints, padded
    pts_valid: object  # [P] bool
    prev_slot: object  # [F] int64 deformation brackets
    next_slot: object  # [F] int64
    alpha: object      # [F] f32
    kf_slot: object    # [F] int64


def make_inputs(order, cur_pos: int, matched_pos: int, ref_slots, init_q, init_t,
                points, capacity: int, brackets) -> ClosureInputs:
    """The host arrays of an attempt: the order padded with its first slot
    to a power of two >= 8 (the JAX package's bucket), the refinement slots
    padded with the matched slot, the keypoints padded to the detector's
    `capacity` (badslam_tpu/frontend.py:1040-1066)."""
    n = len(order)
    bucket = 8
    while bucket < n:
        bucket *= 2
    padded = np.full(bucket, order[0], np.int64)
    padded[:n] = order
    refs = np.full(REFINEMENT_SLOTS, order[matched_pos], np.int64)
    refs[:len(ref_slots)] = ref_slots
    pts = np.zeros((max(capacity, 1), 3), np.float32)
    m = min(len(points), pts.shape[0])
    pts[:m] = np.asarray(points, np.float32)[:m]
    valid = np.arange(pts.shape[0]) < m

    def scalar(x):
        return np.asarray(x, np.int64)

    return ClosureInputs(
        padded, scalar(n), scalar(cur_pos), scalar(matched_pos), scalar(order[cur_pos]),
        refs, np.asarray(init_q, np.float32), np.asarray(init_t, np.float32), pts, valid,
        *(np.asarray(a, np.float32 if i == 2 else np.int64) for i, a in enumerate(brackets)))


def upload(host: ClosureInputs, device: torch.device,
           out: Optional[ClosureInputs] = None) -> ClosureInputs:
    """The host arrays on `device` (through pinned memory, without waiting,
    on a CUDA device), copied into the tensors of `out` when given."""
    tensors = []
    for i, a in enumerate(host):
        src = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            src = src.pin_memory()
        if out is None:
            tensors.append(src.to(device, non_blocking=True))
        else:
            tensors.append(out[i].copy_(src, non_blocking=True))
    return ClosureInputs(*tensors)


def _keyframe_pyramid(ks, slot, key: ClosureKey):
    """The pyramid of the keyframe in `slot` (a [] int64 tensor), built from
    the store's images on the device."""
    return build_pyramid(pick(ks.depth, slot), pick(ks.nx, slot), pick(ks.ny, slot),
                         pick(ks.intensity, slot), key.num_scales, gradmag=key.use_gradmag)


def attempt_closure(key: ClosureKey, cams, cam, ks, traj_q: torch.Tensor,
                    traj_t: torch.Tensor, count: torch.Tensor, inp: ClosureInputs,
                    loop: Control = HOST) -> ClosureResult:
    """One closure attempt (badslam_tpu/frontend.py:987-1080): the current
    keyframe's pyramid, `key.refinements` direct refinements of cur_T_matched
    (each the tracker from RANSAC's pose composed with the matched-to-
    neighbour keyframe pose, the current keyframe as its base), then
    ``apply_closure`` on the keyframe store `ks` and the trajectory. `inp`
    holds device tensors; `loop` is the refinements' Gauss-Newton loop
    control (tracking.pairwise). Reads nothing back but under HOST."""
    matched = pick(inp.order, inp.matched_pos)
    matched_pose = se3.SE3(pick(ks.q, matched), pick(ks.t, matched))
    init = se3.SE3(inp.init_q, inp.init_t)
    cur_pyr = _keyframe_pyramid(ks, inp.cur_slot, key)
    ref_q, ref_t = [], []
    for j in range(key.refinements):
        old = inp.ref_slots[j]
        matched_T_old = se3.mul(se3.inverse(matched_pose),
                                se3.SE3(pick(ks.q, old), pick(ks.t, old)))
        guess = se3.mul(init, matched_T_old)
        res = track_frame_pairwise(
            cams, cur_pyr, _keyframe_pyramid(ks, old, key), guess.q, guess.t, guess.q,
            guess.t, baseline_fx=key.baseline_fx, use_depth=key.use_depth,
            use_descriptor=key.use_descriptor, use_gradmag=key.use_gradmag,
            max_iterations=key.max_iterations, loop=loop)
        refined = se3.mul(se3.SE3(res.q, res.t), se3.inverse(matched_T_old))
        ref_q.append(refined.q)
        ref_t.append(refined.t)
    # Unused slots: copies of the first refinement, masked out by ref_valid
    # (zero weight in every sum, as the JAX package's identity padding).
    ref_q += [ref_q[0]] * (REFINEMENT_SLOTS - key.refinements)
    ref_t += [ref_t[0]] * (REFINEMENT_SLOTS - key.refinements)
    ref_valid = torch.arange(REFINEMENT_SLOTS, device=traj_q.device) < key.refinements
    return apply_closure(
        ks.q, ks.t, inp.order, inp.n_live, inp.cur_pos, inp.matched_pos,
        torch.stack(ref_q), torch.stack(ref_t), ref_valid, inp.pts, inp.pts_valid,
        traj_q, traj_t, inp.prev_slot, inp.next_slot, inp.alpha, inp.kf_slot, count, cam)
