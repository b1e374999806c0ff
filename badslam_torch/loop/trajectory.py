"""Trajectory deformation: drag the non-keyframes along with the keyframes.

Counterpart of ``badslam_tpu/loop/trajectory.py`` (RememberKeyframePoses /
ExtrapolateAndInterpolateKeyframePoseChanges,
trajectory_deformation.cc:33-130): after every BA run and loop closure,
each frame gets the correction implied by the pose changes of its two
bracketing keyframes, interpolated as translation lerp + quaternion slerp
and extrapolated at the trajectory ends; keyframe frames snap exactly to
their new pose. `deform_trajectory` is the front end's (torch, on the
trajectory's device); `extrapolate_and_interpolate_keyframe_pose_changes`
the host float64 version over lists of poses.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from badslam_torch.geometry import se3
from badslam_torch.geometry import se3_np as s3


def deform_trajectory(
    traj_q: torch.Tensor,     # [F, 4] global_T_frame rotations
    traj_t: torch.Tensor,     # [F, 3]
    old_kq: torch.Tensor,     # [K, 4] keyframe poses before BA
    old_kt: torch.Tensor,     # [K, 3]
    new_kq: torch.Tensor,     # [K, 4] keyframe poses after BA
    new_kt: torch.Tensor,     # [K, 3]
    prev_slot: torch.Tensor,  # [F] bracketing keyframe slot (<= frame)
    next_slot: torch.Tensor,  # [F] bracketing keyframe slot (> frame);
                              #     == prev_slot when extrapolating
    alpha: torch.Tensor,      # [F] f32 interpolation fraction in [0, 1]
    kf_slot: torch.Tensor,    # [F] own keyframe slot, or -1
):
    """Returns the deformed (traj_q, traj_t)."""
    P = se3.SE3(traj_q, traj_t)

    def corrected(slots):
        old_k = se3.SE3(old_kq[slots], old_kt[slots])
        new_k = se3.SE3(new_kq[slots], new_kt[slots])
        # new_global_T_frame via keyframe k's change: new_k * old_k^-1 * P
        return se3.mul(se3.mul(new_k, se3.inverse(old_k)), P)

    P_inv = se3.inverse(P)
    corr_a = se3.mul(P_inv, corrected(prev_slot))
    corr_b = se3.mul(P_inv, corrected(next_slot))
    f = alpha[:, None]
    corr = se3.SE3(se3.slerp(corr_a.q, corr_b.q, f),
                   (1.0 - f) * corr_a.t + f * corr_b.t)
    out = se3.mul(P, corr)

    is_kf = (kf_slot >= 0)[:, None]
    own = torch.clamp_min(kf_slot, 0)
    return (torch.where(is_kf, new_kq[own], out.q),
            torch.where(is_kf, new_kt[own], out.t))


def extrapolate_and_interpolate_keyframe_pose_changes(
    frame_poses: List[Optional[s3.SE3]],       # global_T_frame per frame
    kf_frame_indices: Sequence[int],           # dataset frame index per keyframe
    old_kf_T_global: Sequence[s3.SE3],         # frame_T_global before BA
    new_global_T_kf: Sequence[s3.SE3],         # global_T_frame after BA
    start_frame: int = 0,
    end_frame: Optional[int] = None,
) -> List[Optional[s3.SE3]]:
    """Returns the updated global_T_frame list (keyframes set exactly)."""
    n = len(frame_poses)
    end_frame = n - 1 if end_frame is None else min(end_frame, n - 1)
    kf_count = len(kf_frame_indices)
    if kf_count == 0:
        return frame_poses

    out = list(frame_poses)
    kf_by_frame: Dict[int, int] = {f: k for k, f in enumerate(kf_frame_indices)}

    prev_kf = 0
    next_kf = 0
    for fi in range(start_frame, end_frame + 1):
        if out[fi] is None:
            continue
        while next_kf < kf_count and kf_frame_indices[next_kf] <= fi:
            prev_kf = next_kf
            next_kf += 1

        if fi in kf_by_frame:
            out[fi] = new_global_T_kf[kf_by_frame[fi]]
            continue

        old_pose = out[fi]

        def corrected(k: int) -> s3.SE3:
            # new_global_T_frame via keyframe k's change.
            return s3.mul(new_global_T_kf[k], s3.mul(old_kf_T_global[k], old_pose))

        if next_kf >= kf_count or kf_frame_indices[prev_kf] > fi:
            # Extrapolate off the ends.
            out[fi] = corrected(prev_kf)
        else:
            frame_T_global = s3.inverse(old_pose)
            corr_prev = s3.mul(frame_T_global, corrected(prev_kf))
            corr_next = s3.mul(frame_T_global, corrected(next_kf))
            f = (fi - kf_frame_indices[prev_kf]) / float(
                kf_frame_indices[next_kf] - kf_frame_indices[prev_kf])
            corr = s3.SE3(s3.slerp(corr_prev.q, corr_next.q, f),
                          (1 - f) * np.asarray(corr_prev.t) + f * np.asarray(corr_next.t))
            out[fi] = s3.mul(old_pose, corr)
    return out
