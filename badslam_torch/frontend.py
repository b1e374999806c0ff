"""BadSlam front end: the per-frame pipeline and the keyframe BA around it.

Counterpart of ``badslam_tpu/frontend.py`` for the configuration without
loop closure (``enable_loop_detection = false``): preprocess -> pyramid ->
constant-motion prediction -> pairwise tracking against the base keyframe
-> trajectory and history bookkeeping. Every ``keyframe_interval``-th frame
becomes a keyframe of ``DirectBA`` and the new base keyframe; the first
keyframe bootstraps the surfel map. With
``max_num_ba_iterations_per_keyframe > 0`` each later keyframe runs the
alternating bundle adjustment: with ``parallel_ba`` (the default) two
iterations at once and the rest queued, drained two per frame (the
reference's BA thread), or, over a steady run between keyframes when
nothing paces the loop, once after the run, as the JAX package's fused
chunk does; after every BA call the whole trajectory is deformed along
with the keyframes. Frames of a distorted source are
remapped to the loader's pinhole camera, median-filtered when asked, or
downscaled to an input pyramid level first; after the frame loop,
``final_bundle_adjustment`` runs the offline final BA over sliding
keyframe windows and then all keyframes.

Everything runs eagerly on one explicit device. The per-frame state (the
trajectory, the motion history, the base keyframe's pyramid and pose, the
map and the keyframes) lives on that device; the tracker and BA read one
flag per Gauss-Newton or BA iteration back to the host.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from badslam_torch.ba.scheme import DirectBA
from badslam_torch.config import BadSlamConfig
from badslam_torch.geometry import se3
from badslam_torch.io.dataset import RGBDVideo, save_tum_trajectory
from badslam_torch.io.ply import save_ply
from badslam_torch.io.preload import PreLoadThread
from badslam_torch.loop.trajectory import deform_trajectory
from badslam_torch.ops.preprocess import (
    ProcessedFrame,
    downscale_color,
    downscale_depth_median,
    preprocess_frame,
)
from badslam_torch.ops.pyramid import build_pyramid
from badslam_torch.tracking.pairwise import track_frame_pairwise

_log = logging.getLogger("badslam_torch")


def check_supported(config: BadSlamConfig) -> None:
    """Raise NotImplementedError naming each setting of this configuration
    that the port does not do yet, with the later slice that brings it."""
    out = []
    if config.enable_loop_detection:
        out.append("loop detection comes with the loop-closure slice; run "
                   "with --enable_loop_detection false")
    # The input pyramid's refusals are the JAX package's (one shared camera;
    # the reference FATALs on downscaling with the median filter,
    # bad_slam.cc:671-673).
    if config.pyramid_level_for_depth != config.pyramid_level_for_color:
        out.append("input pyramid levels: pyramid_level_for_depth must equal "
                   "pyramid_level_for_color")
    if (config.pyramid_level_for_depth > 0
            and config.median_filter_and_densify_iterations > 0):
        out.append("input pyramid levels cannot be combined with the median "
                   "filter (simultaneous downscaling and median filtering of "
                   "depth maps is not implemented, as in the reference)")
    if config.optimize_intrinsics:
        out.append("optimize_intrinsics (self-calibration) comes with the "
                   "self-calibration slice")
    if config.use_pcg:
        out.append("use_pcg (the PCG BA solver) comes with the PCG slice; the "
                   "alternating solver runs without it")
    if out:
        raise NotImplementedError("badslam_torch: " + "; ".join(out))


def _identity_hist(device: torch.device):
    q = torch.zeros((3, 4), dtype=torch.float32, device=device)
    q[:, 0] = 1.0
    return q, torch.zeros((3, 3), dtype=torch.float32, device=device)


def predict_pose(hist_q: torch.Tensor, hist_t: torch.Tensor, n: int):
    """Constant-motion model from the last <= 3 base_T_frame estimates.
    `hist` rows are oldest first; `n` is the number of valid rows. Returns
    the two estimates (est1, est2) as SE3."""
    last = se3.SE3(hist_q[2], hist_t[2])
    if n < 2:
        return last, last
    prev = se3.SE3(hist_q[1], hist_t[1])
    motion = se3.mul(se3.inverse(prev), last)
    est1 = se3.mul(last, motion)
    if n >= 3:
        pprev = se3.SE3(hist_q[0], hist_t[0])
        prev_motion = se3.mul(se3.inverse(pprev), prev)
        est2 = se3.mul(prev, se3.mul(prev_motion, prev_motion))
    else:
        est2 = est1
    return est1, est2


class BadSlam:
    """Owns the SLAM state and processes frames one at a time."""

    def __init__(self, config: BadSlamConfig, video: RGBDVideo,
                 device: torch.device | str,
                 surfel_capacity: Optional[int] = None):
        check_supported(config)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is "
                               f"not available")
        # Full float32 everywhere: the tracker's and BA's H/b reductions are
        # matmuls, which the JAX package runs at Precision.HIGHEST; TF32
        # would keep only ~3 decimal digits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.config = config
        self.video = video
        self.cam = video.camera
        # Input pyramid level: frames are processed at a coarser resolution
        # (pyramid_level_for_depth/color, bad_slam.cc:666-688).
        self.input_level = config.pyramid_level_for_depth
        self._undistort_map = None
        if video.undistortion_map is not None:
            if self.input_level > 0:
                raise NotImplementedError(
                    "badslam_torch: input pyramid levels cannot be combined "
                    "with undistortion (as in the reference, bad_slam.cc:306)")
            self._undistort_map = torch.from_numpy(
                video.undistortion_map).to(self.device)
        if self.input_level > 0:
            self.cam = self.cam.scaled(0.5 ** self.input_level)
        self.cams_pyramid = tuple(
            self.cam.pyramid_level(i) for i in range(config.num_scales))
        self.direct_ba = DirectBA(self.cam, config, surfel_capacity,
                                  device=self.device)

        # Base keyframe state.
        self.base_kf_id: Optional[int] = None
        self.base_kf_global_T_frame = se3.identity(self.device)
        self.base_kf_pyramid = None
        # Relative pose history vs the base keyframe: [3, 4]/[3, 3], oldest
        # first, plus the host-known number of valid rows.
        self._hist_q, self._hist_t = _identity_hist(self.device)
        self._hist_n = 0

        # Trajectory: global_T_frame per dataset frame + host validity mask.
        n_frames = max(1, len(video))
        ident = se3.identity(self.device, (n_frames,))
        self.traj_q, self.traj_t = ident.q, ident.t
        self.has_pose = np.zeros(n_frames, bool)
        # The last frame processed: a state snapshot resumes after it.
        self.last_frame_index = -1
        # Parallel BA: iterations queued at a keyframe and drained two per
        # frame (the reference's BA-thread queue, bad_slam.h:301-325).
        self.queued_ba_iterations = 0
        self.bundle_adjustment_counter = 0
        # (frame index, milliseconds) of each frame's process_frame call, on
        # the device's clock for CUDA (filled in at the end of run()), the
        # frames that were keyframes and those that drained queued BA.
        self.frame_times_ms: List[Tuple[int, float]] = []
        self.keyframe_frames: List[int] = []
        self.ba_drain_frames: List[int] = []

    # ------------------------------------------------------------------

    def frame_pose(self, frame_index: int) -> Optional[se3.SE3]:
        if not self.has_pose[frame_index]:
            return None
        return se3.SE3(self.traj_q[frame_index], self.traj_t[frame_index])

    def preprocess(self, frame_index: int) -> Tuple[ProcessedFrame, tuple]:
        """Load, upload and preprocess one frame; returns (frame, pyramid)."""
        c = self.config
        raw_to_float = c.raw_to_float_depth
        with record_function("upload"):
            depth_u16 = self.video.depth_u16(frame_index)
            rgb = torch.from_numpy(self.video.color_u8(frame_index)).to(self.device)
            if self.input_level > 0:
                # The input pyramid converts on the host and downscales on
                # the device, as the JAX package does.
                depth = torch.from_numpy(
                    depth_u16.astype(np.float32) * raw_to_float).to(self.device)
                raw_to_float = None
            else:
                depth = torch.from_numpy(depth_u16.astype(np.int32)).to(self.device)
        if self.input_level > 0:
            with record_function("input_downscale"):
                for _ in range(self.input_level):
                    depth = downscale_depth_median(depth)
                    rgb = downscale_color(rgb)
        params = self.direct_ba.depth_params
        with record_function("preprocess"):
            frame = preprocess_frame(
                self.cam, depth, rgb,
                max_depth=c.max_depth,
                sigma_xy=c.bilateral_filter_sigma_xy,
                radius_factor=c.bilateral_filter_radius_factor,
                sigma_inv_depth=c.bilateral_filter_sigma_inv_depth,
                a=params.a,
                cfactor=params.cfactor,
                cell_size=c.sparse_surfel_cell_size,
                raw_to_float_depth=raw_to_float,
                undistort_map=self._undistort_map,
                median_iterations=c.median_filter_and_densify_iterations,
            )
        with record_function("pyramid"):
            pyramid = build_pyramid(
                frame.depth, frame.nx, frame.ny, frame.intensity, c.num_scales,
                gradmag=c.use_gradmag)
        return frame, pyramid

    def run_odometry(self, pyramid) -> se3.SE3:
        """Track the current frame against the base keyframe."""
        c = self.config
        n = min(self._hist_n, 3) if c.use_motion_model else 1
        e1, e2 = predict_pose(self._hist_q, self._hist_t, n)
        result = track_frame_pairwise(
            self.cams_pyramid, self.base_kf_pyramid, pyramid,
            e1.q, e1.t, e2.q, e2.t,
            baseline_fx=c.baseline_fx,
            use_depth=c.use_geometric_residuals,
            use_descriptor=c.use_photometric_residuals and not c.use_gradmag,
            use_gradmag=c.use_gradmag,
            test_two_initial_estimates=c.use_motion_model and self._hist_n >= 3,
            max_iterations=c.tracking_max_iterations,
        )
        return se3.SE3(result.q, result.t)

    def process_frame(self, frame_index: int, drain: bool = True) -> se3.SE3:
        """Full per-frame pipeline (ProcessFrame, bad_slam.cc:174-283).
        Returns the frame's global_T_frame (after BA's trajectory
        deformation on a keyframe that ran BA). With `drain` false the
        queued BA iterations wait (a steady run, see `run`)."""
        c = self.config
        is_first = self.base_kf_id is None
        frame, pyramid = self.preprocess(frame_index)

        if is_first:
            # The first frame's pose is the dataset prior (or the identity),
            # not base * rel.
            base_T_frame = se3.identity(self.device)
            prior = self.video.poses[frame_index]
            global_T_frame = se3.identity(self.device) if prior is None else se3.SE3(
                torch.as_tensor(prior.q, dtype=torch.float32, device=self.device),
                torch.as_tensor(prior.t, dtype=torch.float32, device=self.device))
        else:
            if c.estimate_poses:
                with record_function("track"):
                    base_T_frame = self.run_odometry(pyramid)
            else:
                base_T_frame = se3.SE3(self._hist_q[2], self._hist_t[2])
            global_T_frame = se3.mul(self.base_kf_global_T_frame, base_T_frame)

        self.traj_q[frame_index] = global_T_frame.q
        self.traj_t[frame_index] = global_T_frame.t
        self.has_pose[frame_index] = True
        self._hist_q = torch.cat([self._hist_q[1:], base_T_frame.q[None]])
        self._hist_t = torch.cat([self._hist_t[1:], base_T_frame.t[None]])
        self._hist_n += 1
        self.video.set_pose(frame_index, global_T_frame)
        self.last_frame_index = frame_index

        # Drain queued BA iterations between keyframes (parallel BA).
        if drain:
            self._drain_queued_ba(2, frame_index)

        # Keyframe policy: every keyframe_interval-th processed frame
        # (bad_slam.cc:202-204), plus always the first.
        frames_processed = frame_index - c.start_frame
        if is_first or frames_processed % c.keyframe_interval == 0:
            self._keyframe_budget_guard()
            self.create_keyframe(frame_index, frame, pyramid, global_T_frame)
            if c.max_num_ba_iterations_per_keyframe > 0 and not is_first:
                self.bundle_adjustment_counter += 1
                with record_function("ba"):
                    old = self._remember_keyframe_poses()
                    if c.parallel_ba:
                        # Two iterations now, the rest queued.
                        self.direct_ba.bundle_adjustment(
                            max_iterations=2,
                            do_surfel_updates=c.do_surfel_updates)
                        self.queued_ba_iterations += max(
                            0, c.max_num_ba_iterations_per_keyframe - 2)
                    else:
                        self.direct_ba.bundle_adjustment(
                            max_iterations=c.max_num_ba_iterations_per_keyframe,
                            do_surfel_updates=c.do_surfel_updates)
                    self._apply_ba_pose_updates(*old)
                # BA moved the keyframes: return the deformed pose.
                return self.frame_pose(frame_index)
        return global_T_frame

    def _drain_queued_ba(self, most: int, frame_index: int) -> None:
        """Run up to `most` of the queued BA iterations (one BA call that
        does not end the epoch), then deform the trajectory."""
        if self.queued_ba_iterations <= 0:
            return
        n = min(self.queued_ba_iterations, most)
        with record_function("ba_drain"):
            old = self._remember_keyframe_poses()
            self.direct_ba.bundle_adjustment(
                max_iterations=n, do_surfel_updates=self.config.do_surfel_updates,
                increase_ba_iteration_count=False)
            self.queued_ba_iterations -= n
            self._apply_ba_pose_updates(*old)
        self.ba_drain_frames.append(frame_index)

    def _steady_run_length(self, i: int, end: int) -> int:
        """The number of frames of the steady run starting at frame i, or 0.
        A steady run is the keyframe_interval - 1 frames between two
        keyframes, when nothing paces the loop; the JAX package fuses it
        into one program and drains the queued BA iterations once after
        it, up to 2 per frame of the run (_process_chunk). The port keeps
        that schedule, which decides the results, and processes the frames
        one by one."""
        c = self.config
        n = c.keyframe_interval - 1
        eligible = (
            c.steady_frame_chunking and n >= 2 and self.input_level == 0
            and c.estimate_poses and self.base_kf_id is not None
            and c.fps_restriction <= 0 and c.target_frame_rate <= 0
            and i + n <= end and (i - c.start_frame) % c.keyframe_interval == 1)
        return n if eligible else 0

    def _keyframe_budget_guard(self) -> None:
        """Merge redundant keyframes when the store nears
        max_keyframe_count or free device memory falls under
        min_free_gpu_memory_mb (bad_slam.cc:962-972)."""
        c = self.config
        ks = self.direct_ba.keyframes
        low_memory = False
        if (c.min_free_gpu_memory_mb > 0 and ks.live_count > 4
                and self.device.type == "cuda"):
            free_bytes, _ = torch.cuda.mem_get_info(self.device)
            low_memory = free_bytes / 2**20 < c.min_free_gpu_memory_mb
        if low_memory or ks.live_count >= c.max_keyframe_count - 2:
            freed = ks.merge_redundant_keyframes(4)
            if not freed and ks.live_count >= c.max_keyframe_count:
                _log.warning("keyframe budget exceeded (%d live >= %d) and no "
                             "keyframe was mergeable", ks.live_count,
                             c.max_keyframe_count)

    def create_keyframe(self, frame_index, frame, pyramid, global_T_frame) -> int:
        """Add the frame to DirectBA's keyframes and make it the new base
        keyframe (CreateKeyframe, bad_slam.cc:957-1101); the first keyframe
        bootstraps the map without the observation filter."""
        kf_id = self.direct_ba.add_keyframe(frame, global_T_frame, frame_index)
        if self.base_kf_id is None:
            self.direct_ba.create_surfels_for_keyframe(
                kf_id, filter_new_surfels=False)
        self.keyframe_frames.append(frame_index)
        self.base_kf_id = kf_id
        self.base_kf_global_T_frame = global_T_frame
        self.base_kf_pyramid = pyramid
        self._hist_q, self._hist_t = _identity_hist(self.device)
        self._hist_n = 1
        return kf_id

    # ------------------------------------------------------------------
    # Trajectory deformation after BA
    # ------------------------------------------------------------------

    def _remember_keyframe_poses(self):
        """The keyframe poses before BA (RememberKeyframePoses,
        trajectory_deformation.cc:33-58). BA updates the store in place, so
        this is a copy."""
        ks = self.direct_ba.keyframes
        return ks.q.clone(), ks.t.clone()

    def _bracket_arrays(self):
        """Per frame: the bracketing keyframe slots, the interpolation
        fraction and the frame's own keyframe slot (or -1), from the live
        keyframes' dataset frame indices (host arithmetic)."""
        ks = self.direct_ba.keyframes
        pairs = sorted(
            (f, s) for s, f in enumerate(ks.frame_indices[: ks.count])
            if f >= 0 and s not in ks.free_slot_set)
        n_frames = self.traj_q.shape[0]
        kf_frames = np.array([p[0] for p in pairs], np.int64)
        kf_slots = np.array([p[1] for p in pairs], np.int64)
        nk = len(pairs)
        fi = np.arange(n_frames, dtype=np.int64)
        j = np.searchsorted(kf_frames, fi, side="right")
        prev_i = np.clip(j - 1, 0, nk - 1)
        next_i = np.clip(j, 0, nk - 1)
        interior = (j > 0) & (j < nk)
        # Off both ends: extrapolate through the nearest keyframe (alpha 0,
        # prev == next); inside: the fraction between the two.
        denom = np.maximum(kf_frames[next_i] - kf_frames[prev_i], 1)
        alpha = np.where(interior, (fi - kf_frames[prev_i]) / denom, 0.0)
        end = np.where(j == 0, 0, nk - 1)
        prev_slot = kf_slots[np.where(interior, prev_i, end)]
        next_slot = kf_slots[np.where(interior, next_i, end)]
        kf_slot = np.full(n_frames, -1, np.int64)
        in_range = kf_frames < n_frames
        kf_slot[kf_frames[in_range]] = kf_slots[in_range]

        def dev(x, dtype=torch.int64):
            return torch.as_tensor(x, dtype=dtype).to(self.device)

        return (dev(prev_slot), dev(next_slot), dev(alpha, torch.float32),
                dev(kf_slot))

    def _apply_ba_pose_updates(self, old_kq, old_kt) -> None:
        """After every BA call: deform the whole trajectory along with the
        keyframes (bad_slam.cc:529-534 -> trajectory_deformation.cc:61-130)
        and re-read the base keyframe's pose."""
        ks = self.direct_ba.keyframes
        if ks.count == 0:
            return
        with record_function("trajectory_deformation"):
            prev_slot, next_slot, alpha, kf_slot = self._bracket_arrays()
            self.traj_q, self.traj_t = deform_trajectory(
                self.traj_q, self.traj_t, old_kq, old_kt, ks.q, ks.t,
                prev_slot, next_slot, alpha, kf_slot)
            self.base_kf_global_T_frame = ks.pose(self.base_kf_id)

    def final_bundle_adjustment(self, window_size: int = 16,
                                window_stride: int = 8) -> None:
        """The offline final BA after the frame loop (main.cc:765-809): 10
        iterations over each window of `window_size` keyframe slots, the
        windows `window_stride` apart, then 10 over all keyframes; the
        trajectory is deformed along with the keyframes."""
        if self.config.use_pcg:
            raise NotImplementedError(
                "badslam_torch: the final BA's PCG solver (use_pcg) comes with "
                "the PCG slice")
        kf_count = self.direct_ba.keyframes.count
        if kf_count == 0:
            return
        old = self._remember_keyframe_poses()
        with record_function("final_ba"):
            lo = 0
            while lo < kf_count:
                hi = min(lo + window_size - 1, kf_count - 1)
                self.direct_ba.bundle_adjustment(
                    max_iterations=10, active_keyframe_window=(lo, hi))
                if hi == kf_count - 1:
                    break
                lo += window_stride
            self.direct_ba.bundle_adjustment(
                max_iterations=10, active_keyframe_window=(0, kf_count - 1))
            self._apply_ba_pose_updates(*old)

    def run(self, start: Optional[int] = None, end: Optional[int] = None,
            progress: bool = False) -> None:
        """Process a frame range, with fps_restriction / target_frame_rate
        pacing and the next frame's PNGs decoded on a worker thread."""
        c = self.config
        start = c.start_frame if start is None else start
        end = min(len(self.video), c.end_frame) if end is None else end
        on_cuda = self.device.type == "cuda"
        marks = []
        preload = PreLoadThread(self.video)
        run_last, run_n = start - 1, 0
        try:
            for i in range(start, end):
                t0 = time.perf_counter()
                preload.wait_until_done()
                if i + 1 < end:
                    preload.preload(i + 1)
                if i > run_last:
                    run_n = self._steady_run_length(i, end)
                    run_last = i + run_n - 1
                in_run = i <= run_last

                def step():
                    self.process_frame(i, drain=not in_run)
                    if in_run and i == run_last:
                        self._drain_queued_ba(2 * run_n, i)

                if on_cuda:
                    stream = torch.cuda.current_stream(self.device)
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev1 = torch.cuda.Event(enable_timing=True)
                    ev0.record(stream)
                    step()
                    ev1.record(stream)
                    marks.append((i, ev0, ev1))
                else:
                    t1 = time.perf_counter()
                    step()
                    marks.append((i, 1000.0 * (time.perf_counter() - t1)))
                self.video.clear_frame(i)
                if progress:
                    dt = time.perf_counter() - t0
                    print(f"frame {i}: {1.0 / max(dt, 1e-9):.1f} FPS", flush=True)
                # Pacing: fps_restriction caps playback at the given rate;
                # target_frame_rate simulates the input sensor rate. Both
                # sleep the remainder of the frame's budget.
                min_frame_time = 0.0
                if c.fps_restriction > 0:
                    min_frame_time = 1.0 / c.fps_restriction
                if c.target_frame_rate > 0:
                    min_frame_time = max(min_frame_time, 1.0 / c.target_frame_rate)
                if min_frame_time > 0:
                    dt = time.perf_counter() - t0
                    if dt < min_frame_time:
                        time.sleep(min_frame_time - dt)
        finally:
            preload.stop()
        if on_cuda:
            torch.cuda.synchronize(self.device)
            self.frame_times_ms += [(i, ev0.elapsed_time(ev1))
                                    for i, ev0, ev1 in marks]
        else:
            self.frame_times_ms += marks

    def export_trajectory(self, path: str) -> None:
        q = self.traj_q.cpu().numpy()
        t = self.traj_t.cpu().numpy()
        poses = [se3.SE3(q[i], t[i]) if self.has_pose[i] else None
                 for i in range(len(q))]
        save_tum_trajectory(path, self.video.timestamps, poses)

    def export_point_cloud(self, path: str) -> None:
        """The valid surfels as a binary PLY (positions, normals, colors)."""
        save_ply(path, *self.direct_ba.export_point_cloud())
