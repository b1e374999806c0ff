"""Trajectory deformation: drag the non-keyframes along with the keyframes.

Counterpart of ``badslam_tpu/loop/trajectory.py:25 deform_trajectory_device``
(RememberKeyframePoses / ExtrapolateAndInterpolateKeyframePoseChanges,
trajectory_deformation.cc:33-130): after every BA run, each frame gets the
correction implied by the pose changes of its two bracketing keyframes,
interpolated as translation lerp + quaternion slerp and extrapolated at the
trajectory ends; keyframe frames snap exactly to their new pose.
"""

from __future__ import annotations

import torch

from badslam_torch.geometry import se3


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
