"""Loop-closure application: the gates, the pose graph and the trajectory
deformation.

Counterpart of ``badslam_tpu/loop/closure_device.py`` (the reference's
loop_detector.cc:556-705):

  * consistency gate: at least 2 valid refinements, and every pair of them
    within 10 degrees of viewing direction and 2 cm (loop_detector.cc:
    556-604);
  * the average of the valid refinements (AveragePose, util.h:46);
  * necessity gate: the mean keypoint pixel motion the closure implies must
    exceed 1 px, or fewer than 5 keypoints project (loop_detector.cc:
    624-666);
  * pose-graph Gauss-Newton over the live keyframes in temporal order
    (``pose_graph.optimize_pose_graph_device``), then the deformation of
    the whole trajectory against the pre-closure keyframe poses.

The JAX package folds the gates into device masks so that it never reads
the device. Here, as in the CUDA original, the gate is a host decision: the
two gate flags are read once, and a rejected closure returns without
touching any pose. The JAX package pads the keyframe order to a power of
two for its compile shapes; the port runs the live order as it is.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from badslam_torch.geometry import se3
from badslam_torch.loop.pose_graph import optimize_pose_graph_device
from badslam_torch.loop.trajectory import deform_trajectory

MAX_ANGLE_DIFFERENCE = math.pi / 180.0 * 10.0  # loop_detector.cc:577
MAX_EUCLIDEAN_DISTANCE = 0.02                  # loop_detector.cc:578
AVERAGE_PIXEL_DISTANCE_THRESHOLD = 1.0         # loop_detector.cc:661


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
    q0 = ref_q[torch.argmax(ref_valid.to(torch.int32))]
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
    consistent: bool
    needed: bool
    # The updated store poses and trajectory when both gates passed, else None.
    kq: Optional[torch.Tensor]
    kt: Optional[torch.Tensor]
    traj_q: Optional[torch.Tensor]
    traj_t: Optional[torch.Tensor]

    @property
    def ok(self) -> bool:
        return self.consistent and self.needed


def apply_closure(
    kq: torch.Tensor, kt: torch.Tensor,   # [K, 4/3] keyframe store poses
    order: torch.Tensor,                  # [n] live slots in temporal order
    cur_pos: int,                         # current keyframe's position in order
    matched_pos: int,                     # matched keyframe's position in order
    ref_q: torch.Tensor, ref_t: torch.Tensor,  # [M, 4/3] refined cur_T_matched
    ref_valid: torch.Tensor,              # [M] bool
    pts: torch.Tensor,                    # [N, 3] current keyframe's keypoints (camera frame)
    pts_valid: torch.Tensor,              # [N] bool
    traj_q: torch.Tensor, traj_t: torch.Tensor,  # [F, 4/3] trajectory
    prev_slot, next_slot, alpha, kf_slot,  # [F] deformation brackets
    cam,
    graph_iterations: int = 20,
) -> ClosureResult:
    """Gates, then (when both pass) the pose graph over the ordered live
    keyframes and the trajectory deformation. The inputs are not modified."""
    cur_T_matched = _average_pose(ref_q, ref_t, ref_valid)
    consistent = _consistency_ok(ref_q, ref_t, ref_valid)
    oq, ot = kq[order], kt[order]
    x_cur = se3.SE3(oq[cur_pos], ot[cur_pos])
    x_matched = se3.SE3(oq[matched_pos], ot[matched_pos])
    cur_T_global_est = se3.mul(cur_T_matched, se3.inverse(x_matched))
    needed = _closure_needed(cam, pts, pts_valid, cur_T_global_est, x_cur)
    consistent, needed = torch.stack([consistent, needed]).tolist()  # one read
    if not (consistent and needed):
        return ClosureResult(consistent, needed, None, None, None, None)

    # Loop edge Z = X_matched^-1 X_cur = matched_T_cur.
    z = se3.inverse(cur_T_matched)
    new_oq, new_ot = optimize_pose_graph_device(
        oq, ot, matched_pos, cur_pos, z.q, z.t, iterations=graph_iterations)
    kq2, kt2 = kq.clone(), kt.clone()
    kq2[order], kt2[order] = new_oq, new_ot
    traj_q2, traj_t2 = deform_trajectory(traj_q, traj_t, kq, kt, kq2, kt2,
                                         prev_slot, next_slot, alpha, kf_slot)
    return ClosureResult(True, True, kq2, kt2, traj_q2, traj_t2)
