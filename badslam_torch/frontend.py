"""BadSlam front end: the per-frame pipeline, the keyframe BA around it and
loop closure.

Counterpart of ``badslam_tpu/frontend.py``: preprocess -> pyramid ->
constant-motion prediction -> pairwise tracking against the base keyframe
-> trajectory and history bookkeeping. Every ``keyframe_interval``-th frame
becomes a keyframe of ``DirectBA`` and the new base keyframe; the first
keyframe bootstraps the surfel map. With
``max_num_ba_iterations_per_keyframe > 0`` each later keyframe runs the
alternating bundle adjustment: with ``parallel_ba`` (the default) two
iterations at once and the rest queued, drained two per frame (the
reference's BA thread), or, over a steady run between keyframes when
nothing paces the loop, once after the run, as the JAX package's fused
chunk does; with ``use_pcg`` and sequential BA the PCG solver instead.
With ``optimize_intrinsics`` the keyframe's BA call also self-calibrates
the camera and the depth deformation (from 10 keyframes on, at every call
up to 20, then every ``intrinsics_optimization_interval``-th), and the
next frames are preprocessed and tracked with the updated camera. After
every BA call the whole trajectory is deformed along with the keyframes.
Frames of a distorted source are remapped to the loader's pinhole camera,
median-filtered when asked, or downscaled to an input pyramid level first;
after the frame loop, ``final_bundle_adjustment`` runs the offline final
BA over sliding keyframe windows and then all keyframes, or one PCG pass.

With ``enable_loop_detection`` (the default) every keyframe's host images go
to the loop detector (``loop/detector.py``: features, BoW candidate,
RANSAC), on a worker thread with ``parallel_loop_detection`` (the default),
whose results are applied when the next keyframe arrives and at the end of
``run``. A candidate is refined by three tracker runs against the matched
keyframe and its temporal neighbours, gated, and applied through the pose
graph and the trajectory deformation (``loop/closure.py``).

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

from badslam_torch.ba.pcg import pcg_bundle_adjustment
from badslam_torch.ba.scheme import DirectBA
from badslam_torch.config import BadSlamConfig
from badslam_torch.geometry import se3
from badslam_torch.geometry import se3_np as s3
from badslam_torch.io.dataset import RGBDVideo, save_tum_trajectory
from badslam_torch.io.ply import save_ply
from badslam_torch.io.preload import PreLoadThread
from badslam_torch.loop.closure import apply_closure
from badslam_torch.loop.detector import LoopDetector
from badslam_torch.loop.thread import LoopDetectionThread
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
    if config.n_devices > 1:
        out.append("n_devices > 1: BA over several devices comes with the "
                   "multi-device slice; run with --n_devices 0 or 1")
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
        self._warned_pcg_parallel = False
        # (frame index, milliseconds) of each frame's process_frame call, on
        # the device's clock for CUDA (filled in at the end of run()), the
        # frames that were keyframes and those that drained queued BA.
        self.frame_times_ms: List[Tuple[int, float]] = []
        self.keyframe_frames: List[int] = []
        self.ba_drain_frames: List[int] = []
        # The keyframe frames whose BA call passed the self-calibration gate.
        self.self_calibration_frames: List[int] = []

        # Loop closure (badslam_tpu/frontend.py:365-395).
        self.loop_closure_count = 0
        # One entry per closure attempt: the frame being processed, the two
        # keyframe slots, the refinements run and the two gates' outcomes.
        self.closure_attempts: List[dict] = []
        self.loop_detector: Optional[LoopDetector] = None
        self._loop_thread: Optional[LoopDetectionThread] = None
        self._loop_pending_seq = -1
        # The keyframe count at the last closure attempt (the cooldown,
        # config.loop_closure_cooldown_keyframes).
        self._last_closure_attempt_kf = -(1 << 30)
        if config.enable_loop_detection:
            det_size = None
            if (config.loop_detection_images_width > 0
                    and config.loop_detection_images_height > 0):
                det_size = (config.loop_detection_images_width,
                            config.loop_detection_images_height)
            # Detection-image frequency: the config's, else fps_restriction /
            # keyframe_interval (bad_slam_config.h:371-372); it sets the
            # detector's recency window.
            freq = config.loop_detection_image_frequency
            if freq <= 0 and config.keyframe_interval > 0:
                freq = config.fps_restriction / float(config.keyframe_interval)
            self.loop_detector = LoopDetector(
                cam=self.cam, vocabulary_path=config.loop_detection_vocabulary_path,
                images_size=det_size, image_frequency=freq)
            if config.parallel_loop_detection:
                self._loop_thread = LoopDetectionThread(self.loop_detector)

    def close(self) -> None:
        """Stop the loop-detection worker thread (idempotent)."""
        t, self._loop_thread = self._loop_thread, None
        if t is not None:
            t.stop()

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
                # Self-calibration gate (bad_slam.cc:238-246): not before 10
                # keyframes, every BA run up to 20, then every
                # intrinsics_optimization_interval-th, counted before this run.
                kf_count = self.direct_ba.keyframes.count
                opt_intr = (c.optimize_intrinsics and kf_count >= 10
                            and (kf_count <= 20 or self.bundle_adjustment_counter
                                 % c.intrinsics_optimization_interval == 0))
                self.bundle_adjustment_counter += 1
                if opt_intr:
                    self.self_calibration_frames.append(frame_index)
                with record_function("ba"):
                    old = self._remember_keyframe_poses()
                    self._keyframe_bundle_adjustment(opt_intr)
                    self._apply_ba_pose_updates(*old)
                self._refresh_cameras()
                # BA moved the keyframes: return the deformed pose.
                return self.frame_pose(frame_index)
        return global_T_frame

    def _keyframe_bundle_adjustment(self, opt_intr: bool) -> None:
        """The keyframe's BA call: sequential PCG (use_pcg without
        parallel_ba, bad_slam.cc:485-525), or the alternating solver with
        two iterations now and the rest queued (parallel_ba) or all of them
        now. The reference refuses PCG in parallel mode and runs the
        alternating solver instead (bad_slam.cc:1273-1276)."""
        c = self.config
        if c.use_pcg and c.parallel_ba and not self._warned_pcg_parallel:
            _log.warning("use_pcg is not supported with parallel_ba; using the "
                         "alternating solver (run with --parallel_ba false for PCG)")
            self._warned_pcg_parallel = True
        if c.use_pcg and not c.parallel_ba:
            pcg_bundle_adjustment(
                self.direct_ba,
                max_iterations=min(c.max_num_ba_iterations_per_keyframe, 10),
                optimize_intrinsics=opt_intr and c.use_geometric_residuals,
                do_surfel_updates=c.do_surfel_updates)
            return
        intrinsics = dict(
            optimize_depth_intrinsics=opt_intr and c.use_geometric_residuals,
            optimize_color_intrinsics=opt_intr and c.use_photometric_residuals)
        if c.parallel_ba:
            self.direct_ba.bundle_adjustment(
                max_iterations=2, do_surfel_updates=c.do_surfel_updates, **intrinsics)
            self.queued_ba_iterations += max(0, c.max_num_ba_iterations_per_keyframe - 2)
        else:
            self.direct_ba.bundle_adjustment(
                max_iterations=c.max_num_ba_iterations_per_keyframe,
                do_surfel_updates=c.do_surfel_updates, **intrinsics)

    def _refresh_cameras(self) -> None:
        """After a BA call that self-calibrated: the next frames are
        preprocessed and tracked with the updated camera."""
        if self.direct_ba.intrinsics_updated:
            self.cam = self.direct_ba.cam
            self.cams_pyramid = tuple(
                self.cam.pyramid_level(i) for i in range(self.config.num_scales))
            self.direct_ba.intrinsics_updated = False

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
            for slot in freed:  # the detector forgets merged keyframes
                if self._loop_thread is not None:
                    self._loop_thread.remove(slot)
                elif self.loop_detector is not None:
                    self.loop_detector.remove_keyframe(slot)
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
        if self.loop_detector is not None:
            self._loop_detection_step(kf_id, frame_index)
        return kf_id

    # ------------------------------------------------------------------
    # Loop closure (badslam_tpu/frontend.py:907-1080)
    # ------------------------------------------------------------------

    def _loop_detection_inputs(self, frame_index: int):
        """The detector's host images of a frame: gray (0.299 R + 0.587 G +
        0.114 B, truncated to u8) and calibrated depth, remapped by the
        nearest source pixel to the pinhole camera for a distorted source."""
        rgb = self.video.color_u8(frame_index)
        gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                + 0.114 * rgb[..., 2]).astype(np.uint8)
        depth = (self.video.depth_u16(frame_index).astype(np.float32)
                 * self.config.raw_to_float_depth)
        um = self.video.undistortion_map
        if um is not None:
            h, w = depth.shape
            xi = np.clip(np.floor(um[..., 0]).astype(np.int32), 0, w - 1)
            yi = np.clip(np.floor(um[..., 1]).astype(np.int32), 0, h - 1)
            inside = ((um[..., 0] >= 0) & (um[..., 1] >= 0)
                      & (um[..., 0] < w) & (um[..., 1] < h))
            gray = np.where(inside, gray[yi, xi], 0).astype(np.uint8)
            depth = np.where(inside, depth[yi, xi], 0.0).astype(np.float32)
        return gray, depth

    def register_keyframe_features(self, kf_id: int, frame_index: int) -> None:
        """Register a keyframe with the detector without looking for a
        candidate (a resumed run's live keyframes), through the worker's
        queue when there is one."""
        gray, depth = self._loop_detection_inputs(frame_index)
        if self._loop_thread is not None:
            self._loop_pending_seq = self._loop_thread.register(kf_id, gray, depth)
        else:
            self.loop_detector.add_keyframe(gray, depth, kf_id=kf_id)

    def _loop_detection_step(self, kf_id: int, frame_index: int) -> None:
        """Register the keyframe's features and look for a closure. With
        the worker thread, first apply the results of every detection
        queued up to the previous keyframe (a fixed point in the frame
        stream, one keyframe later than the synchronous path), then queue
        this keyframe."""
        gray, depth = self._loop_detection_inputs(frame_index)
        if self._loop_thread is not None:
            self._drain_loop_detections()
            self._loop_pending_seq = self._loop_thread.enqueue(kf_id, gray, depth)
            return
        det = self.loop_detector
        det.add_keyframe(gray, depth, kf_id=kf_id)
        candidate = det.detect_candidate(kf_id)
        if candidate is None or not self._closure_attempt_allowed():
            return
        init = det.initial_alignment(kf_id, candidate)
        if init is not None:
            self._attempt_loop_closure(kf_id, candidate, init[0])

    def _closure_attempt_allowed(self) -> bool:
        """The cooldown between closure attempts, counted in keyframes
        (the store's slot high-water mark, as in the JAX package)."""
        now = self.direct_ba.keyframes.count
        if now - self._last_closure_attempt_kf < self.config.loop_closure_cooldown_keyframes:
            return False
        self._last_closure_attempt_kf = now
        return True

    def _drain_loop_detections(self) -> None:
        """Wait for the queued detections (re-raising a worker's failure)
        and attempt the closures they found."""
        if self._loop_thread is None or self._loop_pending_seq < 0:
            return
        with record_function("loop_drain_wait"):
            self._loop_thread.wait_through(self._loop_pending_seq)
        for r in self._loop_thread.drain_results():
            if (r.candidate is not None and r.cur_T_matched is not None
                    and self._closure_attempt_allowed()):
                self._attempt_loop_closure(r.kf_id, r.candidate, r.cur_T_matched)

    def _keyframe_pyramid(self, kf_id: int):
        ks = self.direct_ba.keyframes
        return build_pyramid(ks.depth[kf_id], ks.nx[kf_id], ks.ny[kf_id],
                             ks.intensity[kf_id], self.config.num_scales,
                             gradmag=self.config.use_gradmag)

    def _attempt_loop_closure(self, kf_id: int, matched_id: int,
                              cur_T_matched_init: s3.SE3) -> None:
        """Verify a candidate and apply it: direct refinement of
        cur_T_matched against the matched keyframe and its temporal
        neighbours (loop_detector.cc:436-548), then the gates, the pose
        graph and the trajectory deformation (loop/closure.py). A rejected
        candidate leaves every pose as it was."""
        c = self.config
        ks = self.direct_ba.keyframes
        # Live keyframes in temporal order (slots are recycled by merging).
        order = ks.live_slots_in_time_order()
        if kf_id not in order or matched_id not in order:
            return
        cur_pos = order.index(kf_id)
        matched_pos = order.index(matched_id)
        neighbors = [order[j] for j in (matched_pos - 1, matched_pos, matched_pos + 1)
                     if 0 <= j < len(order) and order[j] != kf_id]
        if len(neighbors) < 2:
            return
        with record_function("loop_closure_attempt"):
            dev = self.device
            init_host = se3.SE3(
                torch.as_tensor(np.asarray(cur_T_matched_init.q), dtype=torch.float32).to(dev),
                torch.as_tensor(np.asarray(cur_T_matched_init.t), dtype=torch.float32).to(dev))
            # The current keyframe is the tracker's base: it estimates
            # cur_T_old, initialized from RANSAC and the keyframe poses.
            cur_pyr = self._keyframe_pyramid(kf_id)
            matched_pose = ks.pose(matched_id)
            ref_q, ref_t = [], []
            for old in neighbors:
                matched_T_old = se3.mul(se3.inverse(matched_pose), ks.pose(old))
                init = se3.mul(init_host, matched_T_old)
                res = track_frame_pairwise(
                    self.cams_pyramid, cur_pyr, self._keyframe_pyramid(old),
                    init.q, init.t, init.q, init.t,
                    baseline_fx=c.baseline_fx,
                    use_depth=c.use_geometric_residuals,
                    use_descriptor=c.use_photometric_residuals and not c.use_gradmag,
                    use_gradmag=c.use_gradmag,
                    max_iterations=c.tracking_max_iterations)
                cur_T_matched = se3.mul(se3.SE3(res.q, res.t), se3.inverse(matched_T_old))
                ref_q.append(cur_T_matched.q)
                ref_t.append(cur_T_matched.t)
            pts = torch.as_tensor(self.loop_detector.features[kf_id].points_local).to(dev)
            brackets = self._bracket_arrays()
            out = apply_closure(
                ks.q, ks.t, torch.as_tensor(order, device=dev), cur_pos, matched_pos,
                torch.stack(ref_q), torch.stack(ref_t),
                torch.ones(len(ref_q), dtype=torch.bool, device=dev),
                pts, torch.ones(len(pts), dtype=torch.bool, device=dev),
                self.traj_q, self.traj_t, *brackets, self.cam)
            self.closure_attempts.append(dict(
                frame=self.last_frame_index, kf=kf_id, matched=matched_id,
                refinements=len(neighbors), consistent=out.consistent,
                needed=out.needed))
            if out.ok:
                ks.q.copy_(out.kq)
                ks.t.copy_(out.kt)
                self.traj_q, self.traj_t = out.traj_q, out.traj_t
                self.base_kf_global_T_frame = ks.pose(self.base_kf_id)
                self.loop_closure_count += 1

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
        windows `window_stride` apart, then 10 over all keyframes; with
        use_pcg instead one PCG pass of 10 outer iterations, self-calibrating
        with optimize_intrinsics. The trajectory is deformed along with the
        keyframes. As in the JAX package, the front end's camera stays the
        one from before the PCG pass (DirectBA holds the pass's camera), so
        --export_calibration pairs it with the pass's depth deformation."""
        kf_count = self.direct_ba.keyframes.count
        if kf_count == 0:
            return
        old = self._remember_keyframe_poses()
        if self.config.use_pcg:
            with record_function("final_ba"):
                pcg_bundle_adjustment(self.direct_ba, max_iterations=10,
                                      optimize_intrinsics=self.config.optimize_intrinsics)
                self._apply_ba_pose_updates(*old)
            return
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
        # Apply the closures still in flight on the detection thread.
        self._drain_loop_detections()
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
