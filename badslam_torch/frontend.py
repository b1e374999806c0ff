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
graph and the trajectory deformation (``loop/closure.py``), all with no
host read, as in the JAX package: on a CUDA device as one replay of the
attempt's captured CUDA graph (``loop.graph.ClosureGraph``), on the CPU
eagerly under ``closure_loop``; ``closure_graph = None`` makes a card run
the eager call. ``loop_closure_count`` reads the device counter.

``run_live`` consumes a live stream (``io/live_inputs.py``) frame by frame
as it arrives. With a ``live_viewer`` (``viz/viewer.py``) every keyframe
may snapshot the map, and before each frame the loop waits while the
viewer is paused and applies its queued commands (manual BA, densify,
runtime config edits, keyframe move and delete).

Everything runs on one explicit device. The per-frame state (the
trajectory, the motion history, the base keyframe's pyramid and pose, the
map and the keyframes) lives on that device. Every tracked frame at input
level 0 (all but the first, when ``estimate_poses`` is on) is the JAX
package's steady frame (``steady.steady_frame``: preprocess, pyramid,
motion model, tracking, trajectory and history writes): on a CUDA device
one replay of a captured CUDA graph (``steady.SteadyFrameGraph``) whose
Gauss-Newton early exit is decided on the card, so no value is read back
between the frame's upload and the next frame; on the CPU the same
function runs eagerly, reading the convergence flag once per Gauss-Newton
iteration. When nothing paces the loop, the ``keyframe_interval - 1``
frames between two keyframes run as one chunk (``chunk_eligible``,
``_process_chunk``; ``steady_frame_chunking``): one batched upload, then one
replay per frame with no host read in between, and the queued BA
iterations are drained once after the chunk, up to 2 per frame of it, as
the JAX package's scan chunk does. The first frame, ``estimate_poses``
false and input pyramid levels take the per-frame path, as in the JAX
package. Every BA call of the frame loop that the JAX package runs as its
fused program (the keyframe's call and every drain, per frame and after a
chunk) is the port's fused BA call (``ba/scheme.py``): on a CUDA device
one replay of a captured CUDA graph (``ba.graph.BAGraph``) whose exits are
decided on the card, so a chunk's replays and its drain queue with no host
read; on the CPU the same function eagerly with the host loops
(``ba_loop``, ``HOST``; ``MASKED`` reads nothing). ``ba_graph = None`` makes
a card run the eager call. With ``sync_surfel_bucket`` an epoch-ending call
reads the surfel count once, as in the JAX package. A dataset of known
length sizes the keyframe store and the surfel bound up front (the JAX
package's pre-sizing). With ``n_devices > 1`` each BA call runs over a mesh
of devices, and the map and keyframes stay on the one device between
calls: the same fused call, one graph replay per call when every shard is
on this card (a mesh that repeats it), else eagerly under ``ba_loop`` (a
mesh over several cards, logged once at construction).

Timed regions (``utils/timing.py``, on the card's clock on a GPU) carry the
JAX package's timer names: ``frame (fused)`` (a steady frame, its upload
included), ``frame chunk (fused)`` and ``frame chunk upload`` (a chunk of
steady frames and its batched upload), ``preprocessing`` and ``odometry``
(the per-frame path), ``keyframe insert``, ``bundle adjustment`` (the
keyframe's BA call; the drains between frames are not timed, as there),
``bundle adjustment (PCG)``, ``loop detection (sync)``, ``loop closure
attempt``, ``loop detection drain (wait)`` and ``trajectory deformation``;
the BA stages and the detection worker add theirs. On a card the graphs
add the device stamps of their replays, WHILE nodes and BA stages as
``<name> [graph]`` timers, folded in when ``run`` flushes the launch
counts, and ``device_timeline`` maps the last replays onto the profiler's
clock; ``run`` logs the graphs it captured, by reason.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import Counter
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from badslam_torch.ba.graph import BAGraph
from badslam_torch.ba.pcg import pcg_bundle_adjustment
from badslam_torch.ba.scheme import DirectBA
from badslam_torch.config import BadSlamConfig
from badslam_torch.geometry import se3
from badslam_torch.geometry import se3_np as s3
from badslam_torch.io.dataset import RGBDVideo, save_tum_trajectory
from badslam_torch.io.ply import save_ply
from badslam_torch.io.preload import PreLoadThread
from badslam_torch.loop import closure
from badslam_torch.loop.graph import ClosureGraph
from badslam_torch.loop.detector import LoopDetector
from badslam_torch.loop.features import gray_from_rgb
from badslam_torch.loop.thread import LoopDetectionThread
from badslam_torch.loop.trajectory import deform_trajectory
from badslam_torch.ops import kernels
from badslam_torch.ops.conditional import HOST
from badslam_torch.ops.preprocess import (
    ProcessedFrame,
    downscale_color,
    downscale_depth_median,
    preprocess_frame,
)
from badslam_torch.ops.pyramid import build_pyramid
from badslam_torch.steady import SteadyFrameGraph, steady_frame, steady_key
from badslam_torch.tracking.pairwise import track_frame_pairwise
from badslam_torch.utils.memory import free_device_memory_mb
from badslam_torch.utils.timing import Timing, region

_log = logging.getLogger("badslam_torch")


def check_supported(config: BadSlamConfig) -> None:
    """Raise NotImplementedError naming each setting of this configuration
    that the port does not do yet, with the later slice that brings it."""
    out = []
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
                 surfel_capacity: Optional[int] = None, mesh=None):
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
        # BA over a device mesh with config.n_devices > 1 (or the given
        # `mesh`, a parallel.Mesh); the rest of the pipeline stays on device.
        self.direct_ba = DirectBA(self.cam, config, surfel_capacity,
                                  device=self.device, mesh=mesh)
        # A dataset of known length: the keyframe store and the surfel bound
        # sized for its keyframes up front, so no capacity grows and the
        # BA graphs' buckets change less (badslam_tpu/frontend.py:330-343).
        if (not hasattr(video, "wait_for_frame") and len(video) > 0
                and config.keyframe_interval > 0):
            frames = max(0, min(len(video), config.end_frame) - config.start_frame)
            expected = min(frames // config.keyframe_interval + 2,
                           config.max_keyframe_count)
            self.direct_ba.keyframes._ensure_capacity(expected)
            self.direct_ba.prebudget_epochs(expected)
        # The fused BA calls: on a CUDA device as graph replays, else eagerly
        # under the loop control ba_loop. A mesh whose shards are not all on
        # this card runs its calls eagerly: one graph holds one card's work.
        self.ba_graph = BAGraph(self.device) if self.device.type == "cuda" else None
        self.ba_loop = HOST
        ba_mesh = self.direct_ba.mesh
        if self.ba_graph is not None and ba_mesh is not None and (
                ba_mesh.distinct() != [self.ba_graph.device]):
            _log.info("BA over %s runs eagerly under ba_loop: a CUDA graph holds the "
                      "calls of a mesh whose shards share one card", ba_mesh)
            self.ba_graph = None

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
        # The steady frame (steady.py): taken at input level 0; its
        # configuration key; on a CUDA device its graphs and static inputs.
        self._steady_ok = self.input_level == 0
        self._steady_key = steady_key(config)
        self.steady_graph = (SteadyFrameGraph(self.device)
                             if self.device.type == "cuda" else None)
        # The Gauss-Newton loop control of the eager steady frames (HOST;
        # MASKED reads nothing).
        self.steady_loop = HOST
        self.chunks_processed = 0  # steady chunks run (_process_chunk)
        self._eager_gn_iterations = 0  # the host loop's, in steady frames
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
        # run_live: per frame, the host seconds from the frame's push by
        # the capture thread to the end of its process_frame (the
        # capture-to-pose lag) and the frames captured but not yet
        # processed at that point (the backlog).
        self.live_lag_s: List[Tuple[int, float]] = []
        self.live_backlog: List[int] = []
        # The live map view (viz.viewer.LiveViewer), set by the caller: a
        # snapshot after every interval-th keyframe (a device read) and
        # run controls before each frame.
        self.live_viewer = None

        # Loop closure (badslam_tpu/frontend.py:365-395). The closures
        # applied, counted on the device (loop_closure_count reads it).
        self._closure_count = torch.zeros((), dtype=torch.int64, device=self.device)
        # One entry per closure attempt: the frame being processed, the two
        # keyframe slots, the refinements run and the two gates' outcomes
        # (device bools until closure_attempts reads them).
        self._closure_attempts: List[dict] = []
        # The attempts: on a CUDA device as graph replays, else eagerly under
        # the loop control closure_loop (HOST; MASKED reads nothing).
        self.closure_graph = (ClosureGraph(self.device)
                              if self.device.type == "cuda" else None)
        self.closure_loop = HOST
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

    @property
    def loop_closure_count(self) -> int:
        """The loop closures applied (a device read: for reports and
        snapshots, badslam_tpu/frontend.py:440-448)."""
        return int(self._closure_count)

    @loop_closure_count.setter
    def loop_closure_count(self, value: int) -> None:
        self._closure_count.fill_(int(value))

    @property
    def closure_attempts(self) -> List[dict]:
        """One dict per closure attempt: frame, kf, matched, refinements,
        consistent, needed. The gates' outcomes are read from the device
        the first time an attempt is read here."""
        for a in self._closure_attempts:
            if isinstance(a["consistent"], torch.Tensor):
                a["consistent"], a["needed"] = (
                    bool(x) for x in torch.stack([a["consistent"], a["needed"]]).tolist())
        return self._closure_attempts

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

    def _steady_step(self, frame_index: int, depth=None, rgb=None):
        """One steady frame and its bookkeeping: on a CUDA device a replay
        of the frame's graph (the frame was uploaded or set just before),
        whose static trajectory, history and base pyramid become the front
        end's; on the CPU the same function, eagerly, on the frame's raw
        depth (int32) and color tensors (read from the video when not
        given). Returns (frame, pyramid, global_T_frame); frame and pyramid
        are the graph's outputs on a CUDA device, valid until its next
        replay."""
        c = self.config
        params = self.direct_ba.depth_params
        base = self.base_kf_global_T_frame
        test_two = c.use_motion_model and self._hist_n >= 3
        state = dict(base_pyr=self.base_kf_pyramid, base_q=base.q, base_t=base.t,
                     a=params.a, cfactor=params.cfactor, traj_q=self.traj_q,
                     traj_t=self.traj_t, hist_q=self._hist_q, hist_t=self._hist_t)
        with record_function("steady_frame"):
            if self.steady_graph is not None:
                out = self.steady_graph.run(
                    self._steady_key, self.cam, self.cams_pyramid, self._undistort_map,
                    test_two=test_two, frame_index=frame_index, **state)
                self.base_kf_pyramid = self.steady_graph.base_pyr
                # The graph's pose output is overwritten by its next replay.
                global_T_frame = se3.SE3(out.q.clone(), out.t.clone())
            else:
                if depth is None:
                    depth = torch.from_numpy(
                        self.video.depth_u16(frame_index).astype(np.int32)).to(self.device)
                    rgb = torch.from_numpy(self.video.color_u8(frame_index)).to(self.device)
                out = steady_frame(
                    self._steady_key, self.cam, self.cams_pyramid, depth_raw=depth,
                    rgb=rgb, undistort_map=self._undistort_map,
                    idx=torch.tensor([frame_index], device=self.device),
                    test_two=test_two, loop=self.steady_loop, **state)
                global_T_frame = se3.SE3(out.q, out.t)
                self._eager_gn_iterations += sum(out.iterations)
        self.traj_q, self.traj_t = out.traj_q, out.traj_t
        self._hist_q, self._hist_t = out.hist_q, out.hist_t
        self.has_pose[frame_index] = True
        self._hist_n += 1
        self.video.set_pose(frame_index, global_T_frame)
        self.last_frame_index = frame_index
        return out.frame, out.pyramid, global_T_frame

    def steady_gn_iterations(self) -> int:
        """The Gauss-Newton iterations of the steady frames so far, all
        scales (with graphs, a device read)."""
        n = self._eager_gn_iterations
        if self.steady_graph is not None:
            n += self.steady_graph.gn_iterations()
        return n

    def process_frame(self, frame_index: int) -> se3.SE3:
        """Full per-frame pipeline (ProcessFrame, bad_slam.cc:174-283).
        Returns the frame's global_T_frame (after BA's trajectory
        deformation on a keyframe that ran BA)."""
        c = self.config
        is_first = self.base_kf_id is None
        if not is_first and c.estimate_poses and self._steady_ok:
            with Timing.time("frame (fused)", device=self.device):
                if self.steady_graph is not None:
                    with record_function("upload"):
                        self.steady_graph.upload(self.video.depth_u16(frame_index),
                                                 self.video.color_u8(frame_index))
                frame, pyramid, global_T_frame = self._steady_step(frame_index)
        else:
            with Timing.time("preprocessing", device=self.device):
                frame, pyramid = self.preprocess(frame_index)
            if is_first:
                # The first frame's pose is the dataset prior (or the
                # identity), not base * rel.
                base_T_frame = se3.identity(self.device)
                prior = self.video.poses[frame_index]
                global_T_frame = se3.identity(self.device) if prior is None else se3.SE3(
                    torch.as_tensor(prior.q, dtype=torch.float32, device=self.device),
                    torch.as_tensor(prior.t, dtype=torch.float32, device=self.device))
            else:
                if c.estimate_poses:
                    with record_function("track"), \
                            Timing.time("odometry", device=self.device):
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
                # BA moved the keyframes: return the deformed pose (a copy:
                # the trajectory is a graph's static buffer on a card).
                pose = self.frame_pose(frame_index)
                return se3.SE3(pose.q.clone(), pose.t.clone())
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
            with Timing.time("bundle adjustment (PCG)", device=self.device):
                pcg_bundle_adjustment(
                    self.direct_ba,
                    max_iterations=min(c.max_num_ba_iterations_per_keyframe, 10),
                    optimize_intrinsics=opt_intr and c.use_geometric_residuals,
                    do_surfel_updates=c.do_surfel_updates)
            return
        intrinsics = dict(
            optimize_depth_intrinsics=opt_intr and c.use_geometric_residuals,
            optimize_color_intrinsics=opt_intr and c.use_photometric_residuals)
        with Timing.time("bundle adjustment", device=self.device):
            self.direct_ba.bundle_adjustment(
                max_iterations=2 if c.parallel_ba else c.max_num_ba_iterations_per_keyframe,
                do_surfel_updates=c.do_surfel_updates, loop=self.ba_loop,
                graph=self.ba_graph, **intrinsics)
        if c.parallel_ba:
            self.queued_ba_iterations += max(0, c.max_num_ba_iterations_per_keyframe - 2)

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
                increase_ba_iteration_count=False, loop=self.ba_loop,
                graph=self.ba_graph)
            self.queued_ba_iterations -= n
            self._apply_ba_pose_updates(*old)
        self.ba_drain_frames.append(frame_index)

    def _chunk_len(self) -> int:
        """The steady frames between two keyframes."""
        return self.config.keyframe_interval - 1

    def chunk_eligible(self, i: int, end: int) -> bool:
        """Whether frames [i, i + chunk_len) are the steady frames between
        two keyframes, to run as one chunk: chunking on, at least 2 frames,
        the steady path, no pacing, no live viewer and no live stream
        (badslam_tpu/frontend.py:794-809)."""
        c = self.config
        n = self._chunk_len()
        return (
            c.steady_frame_chunking and n >= 2
            and self._steady_ok and c.estimate_poses
            and self.base_kf_id is not None
            and self.live_viewer is None
            and c.fps_restriction <= 0 and c.target_frame_rate <= 0
            and not hasattr(self.video, "wait_for_frame")
            and i + n <= end
            # the chunk must sit exactly between two keyframes
            and (i - c.start_frame) % c.keyframe_interval == 1)

    def _process_chunk(self, start: int, n: int, marks: list) -> None:
        """Run the `n` steady frames from `start` as one chunk
        (badslam_tpu/frontend.py:811-865): one batched upload of their raw
        depth and color, then the steady frame of each, on a CUDA device
        one graph replay per frame with no host read in between; then drain
        the queued BA iterations once, up to 2 per frame of the chunk, after
        the chunk's trajectory writes, so the drain's trajectory deformation
        corrects the chunk's frames as the per-frame path's does. Appends
        each frame's timed region to `marks`: the first frame's includes the
        upload, the last frame's the drain."""
        graph = self.steady_graph
        depths = [self.video.depth_u16(start + j) for j in range(n)]
        rgbs = [self.video.color_u8(start + j) for j in range(n)]
        last = contextlib.ExitStack()
        with Timing.time("frame chunk (fused)", device=self.device):
            for j in range(n):
                i = start + j
                with contextlib.ExitStack() as frame_stack:
                    # The last frame's region stays open through the drain.
                    span = (last if j == n - 1 else frame_stack).enter_context(
                        region(self.device))
                    marks.append((i, span))
                    if j == 0:
                        with Timing.time("frame chunk upload", device=self.device):
                            if graph is not None:
                                batch = graph.upload_chunk(depths, rgbs)
                            else:
                                batch = (torch.from_numpy(np.stack(depths).astype(np.int32))
                                         .to(self.device),
                                         torch.from_numpy(np.stack(rgbs)).to(self.device))
                    if graph is not None:
                        graph.set_frame(batch[0][j], batch[1][j])
                        self._steady_step(i)
                    else:
                        self._steady_step(i, batch[0][j], batch[1][j])
        with last:
            self._drain_queued_ba(2 * n, start + n - 1)
        self.chunks_processed += 1

    def _keyframe_budget_guard(self) -> None:
        """Merge redundant keyframes when the store nears
        max_keyframe_count or free device memory falls under
        min_free_gpu_memory_mb (bad_slam.cc:962-972)."""
        c = self.config
        ks = self.direct_ba.keyframes
        low_memory = False
        if c.min_free_gpu_memory_mb > 0 and ks.live_count > 4:
            free_mb = free_device_memory_mb(self.device)
            low_memory = free_mb is not None and free_mb < c.min_free_gpu_memory_mb
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
        with Timing.time("keyframe insert", device=self.device):
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
        if self.live_viewer is not None:
            self.live_viewer.on_keyframe(self)
        return kf_id

    # ------------------------------------------------------------------
    # Loop closure (badslam_tpu/frontend.py:907-1080)
    # ------------------------------------------------------------------

    def _loop_detection_inputs(self, frame_index: int):
        """The detector's host images of a frame: gray (0.299 R + 0.587 G +
        0.114 B, truncated to u8) and calibrated depth, remapped by the
        nearest source pixel to the pinhole camera for a distorted source."""
        gray = gray_from_rgb(self.video.color_u8(frame_index))
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
        with Timing.time("loop detection (sync)"):
            det.add_keyframe(gray, depth, kf_id=kf_id)
            candidate = det.detect_candidate(kf_id)
        if candidate is None or not self._closure_attempt_allowed():
            return
        init = det.initial_alignment(kf_id, candidate)
        if init is not None:
            with Timing.time("loop closure attempt", device=self.device):
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
        with record_function("loop_drain_wait"), \
                Timing.time("loop detection drain (wait)"):
            self._loop_thread.wait_through(self._loop_pending_seq)
        for r in self._loop_thread.drain_results():
            if (r.candidate is not None and r.cur_T_matched is not None
                    and self._closure_attempt_allowed()):
                with Timing.time("loop closure attempt", device=self.device):
                    self._attempt_loop_closure(r.kf_id, r.candidate, r.cur_T_matched)

    def _attempt_loop_closure(self, kf_id: int, matched_id: int,
                              cur_T_matched_init: s3.SE3) -> None:
        """Verify a candidate and apply it with no host read
        (badslam_tpu/frontend.py:987-1080): the host supplies only
        value-free metadata (the live order, the refinements' slots,
        RANSAC's pose, the detector's keypoints, the deformation brackets);
        the refinements, the gates, the pose graph and the gated in-place
        update of the keyframe poses, the trajectory and the closure counter
        run on the device (loop/closure.py), on a CUDA device as one replay
        of the attempt's graph (loop/graph.py). A rejected candidate leaves
        every pose bit-identical."""
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
        det = self.loop_detector
        points = det.features[kf_id].points_local if det is not None else np.zeros((0, 3))
        host = closure.make_inputs(
            order, cur_pos, matched_pos, neighbors, cur_T_matched_init.q,
            cur_T_matched_init.t, points, det.max_features if det is not None else 1,
            self._bracket_host())
        key = closure.ClosureKey(
            c.num_scales, c.use_gradmag, c.baseline_fx, c.use_geometric_residuals,
            c.use_photometric_residuals and not c.use_gradmag, c.tracking_max_iterations,
            len(neighbors))
        with record_function("loop_closure_attempt"):
            state = (self.cams_pyramid, self.cam, ks, self.traj_q, self.traj_t,
                     self._closure_count)
            if self.closure_graph is not None:
                out = self.closure_graph.run(key, *state, host)
            else:
                out = closure.attempt_closure(key, *state, closure.upload(host, self.device),
                                              loop=self.closure_loop)
            self._closure_attempts.append(dict(
                frame=self.last_frame_index, kf=kf_id, matched=matched_id,
                refinements=len(neighbors), consistent=out.consistent,
                needed=out.needed))
            # The odometry anchor (a device copy, not a read).
            self.base_kf_global_T_frame = ks.pose(self.base_kf_id)

    # ------------------------------------------------------------------
    # Live viewer commands (badslam_tpu/frontend.py:1084-1200)
    # ------------------------------------------------------------------

    # Config fields the viewer's settings panel may edit during a run: the
    # ones the frame loop reads anew every frame.
    RUNTIME_CONFIG_FIELDS = (
        "fps_restriction", "target_frame_rate", "keyframe_interval",
        "max_num_ba_iterations_per_keyframe", "parallel_ba",
        "do_surfel_updates", "steady_frame_chunking",
        "min_free_gpu_memory_mb",
    )

    def _apply_config_edit(self, assignment: str) -> None:
        """Apply one `key=value` edit, the value coerced to the field's
        type; other keys, bad values and a keyframe_interval below 1 are
        ignored with a warning."""
        key, _, raw = assignment.partition("=")
        if key not in self.RUNTIME_CONFIG_FIELDS:
            _log.warning("ignoring config edit for %r (not runtime-editable)", key)
            return
        cur = getattr(self.config, key)
        try:
            if isinstance(cur, bool):
                val = raw.strip().lower() in ("1", "true", "on", "yes")
            elif isinstance(cur, int):
                val = int(raw)
            elif isinstance(cur, float):
                val = float(raw)
            else:
                val = raw
        except ValueError:
            _log.warning("ignoring config edit %r (bad value)", assignment)
            return
        if key == "keyframe_interval" and val < 1:  # the frame loop divides by it
            _log.warning("ignoring config edit %r (must be at least 1)", assignment)
            return
        setattr(self.config, key, val)

    def _apply_viewer_commands(self) -> None:
        """Apply the commands queued by the live viewer's /control endpoint,
        on the SLAM thread (wait_if_paused's on_wake hook): manual BA (4
        iterations, then the trajectory deformation), densify (surfels for
        the base keyframe), `set:key=value`, and the keyframe move and
        delete tools; each but `set:` is followed by a snapshot."""
        lv = self.live_viewer
        if lv is None:
            return
        for cmd in lv.take_commands():
            if cmd == "ba" and self.direct_ba.keyframes.count > 0:
                old = self._remember_keyframe_poses()
                self.direct_ba.bundle_adjustment(
                    max_iterations=4, do_surfel_updates=self.config.do_surfel_updates)
                self._apply_ba_pose_updates(*old)
                lv.snapshot(self)
            elif cmd == "densify" and self.base_kf_id is not None:
                self.direct_ba.create_surfels_for_keyframe(
                    self.base_kf_id, filter_new_surfels=False)
                lv.snapshot(self)
            elif cmd.startswith("set:"):
                self._apply_config_edit(cmd[len("set:"):])
            elif cmd.startswith("move_kf:"):
                self._debug_move_keyframe(cmd[len("move_kf:"):])
                lv.snapshot(self)
            elif cmd.startswith("delete_kf:"):
                self._debug_delete_keyframe(cmd[len("delete_kf:"):])
                lv.snapshot(self)

    def _debug_move_keyframe(self, spec: str) -> None:
        """`<slot>:<dx>,<dy>,<dz>`: translate a live keyframe's pose (the
        reference GUI's manual frame move); the next BA should pull it
        back."""
        try:
            slot_s, _, vec = spec.partition(":")
            slot = int(slot_s)
            dx, dy, dz = (float(v) for v in vec.split(","))
        except ValueError:
            _log.warning("ignoring malformed move_kf command %r", spec)
            return
        ks = self.direct_ba.keyframes
        if not (0 <= slot < ks.count) or slot in ks.free_slot_set:
            _log.warning("move_kf: slot %d is not a live keyframe", slot)
            return
        pose = ks.pose(slot)
        moved = se3.SE3(pose.q, pose.t + torch.tensor(
            [dx, dy, dz], dtype=torch.float32, device=self.device))
        ks.set_pose(slot, moved)
        if slot == self.base_kf_id:
            self.base_kf_global_T_frame = moved

    def _debug_delete_keyframe(self, spec: str) -> None:
        """`<slot>`: delete a live keyframe other than the odometry base;
        its slot is recycled and the loop detector forgets it (through the
        worker's queue when there is one)."""
        try:
            slot = int(spec)
        except ValueError:
            _log.warning("ignoring malformed delete_kf command %r", spec)
            return
        ks = self.direct_ba.keyframes
        if not (0 <= slot < ks.count) or slot in ks.free_slot_set:
            _log.warning("delete_kf: slot %d is not a live keyframe", slot)
            return
        if slot == self.base_kf_id or ks.live_count <= 1:
            _log.warning("delete_kf: refusing to delete the odometry base "
                         "keyframe (slot %d)", slot)
            return
        ks.remove_keyframe(slot)
        if self._loop_thread is not None:
            self._loop_thread.remove(slot)
        elif self.loop_detector is not None:
            self.loop_detector.remove_keyframe(slot)

    # ------------------------------------------------------------------
    # Trajectory deformation after BA
    # ------------------------------------------------------------------

    def _remember_keyframe_poses(self):
        """The keyframe poses before BA (RememberKeyframePoses,
        trajectory_deformation.cc:33-58). BA updates the store in place, so
        this is a copy."""
        ks = self.direct_ba.keyframes
        return ks.q.clone(), ks.t.clone()

    def _bracket_host(self):
        """Per frame: the bracketing keyframe slots, the interpolation
        fraction and the frame's own keyframe slot (or -1), from the live
        keyframes' dataset frame indices (host arithmetic, numpy)."""
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
        return prev_slot, next_slot, alpha.astype(np.float32), kf_slot

    def _bracket_arrays(self):
        """The brackets of _bracket_host on the device (through pinned
        memory, without waiting, on a CUDA device)."""
        out = []
        for x in self._bracket_host():
            host = torch.from_numpy(x)
            if self.device.type == "cuda":
                host = host.pin_memory()
            out.append(host.to(self.device, non_blocking=True))
        return tuple(out)

    def _apply_ba_pose_updates(self, old_kq, old_kt) -> None:
        """After every BA call: deform the whole trajectory along with the
        keyframes (bad_slam.cc:529-534 -> trajectory_deformation.cc:61-130)
        and re-read the base keyframe's pose. The trajectory is written in
        place, so its buffers (a steady graph's static inputs on a card, and
        the closure graph's key) keep their storage."""
        ks = self.direct_ba.keyframes
        if ks.count == 0:
            return
        with record_function("trajectory_deformation"), \
                Timing.time("trajectory deformation", device=self.device):
            prev_slot, next_slot, alpha, kf_slot = self._bracket_arrays()
            q, t = deform_trajectory(self.traj_q, self.traj_t, old_kq, old_kt, ks.q, ks.t,
                                     prev_slot, next_slot, alpha, kf_slot)
            self.traj_q.copy_(q)
            self.traj_t.copy_(t)
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

    def _timed_step(self, i: int, step, marks: list) -> None:
        """Run step() (frame i's work) as one timed region (CUDA events on a
        GPU, the host clock on the CPU); read by _collect_frame_times."""
        with region(self.device) as span:
            step()
        marks.append((i, span))

    def _collect_frame_times(self, marks: list) -> None:
        self.frame_times_ms += [(i, span.ms) for i, span in marks]

    def _wait_for_viewer(self) -> None:
        """The live viewer's run controls: block while paused, applying its
        queued commands (badslam_tpu/frontend.py:1281-1285)."""
        if self.live_viewer is not None:
            self.live_viewer.wait_if_paused(on_wake=self._apply_viewer_commands)

    def run(self, start: Optional[int] = None, end: Optional[int] = None,
            progress: bool = False) -> None:
        """Process a frame range, with fps_restriction / target_frame_rate
        pacing and the next frame's PNGs decoded on a worker thread."""
        c = self.config
        start = c.start_frame if start is None else start
        end = min(len(self.video), c.end_frame) if end is None else end
        marks = []
        held = {kind: len(caps) for kind, caps in self._graph_captures().items()}
        preload = PreLoadThread(self.video)
        try:
            i = start
            while i < end:
                self._wait_for_viewer()
                t0 = time.perf_counter()
                preload.wait_until_done()
                if self.chunk_eligible(i, end):
                    step = self._chunk_len()
                    if i + step < end:
                        preload.preload(i + step)
                    self._process_chunk(i, step, marks)
                else:
                    step = 1
                    if i + 1 < end:
                        preload.preload(i + 1)
                    self._timed_step(i, lambda: self.process_frame(i), marks)
                for j in range(i, i + step):
                    self.video.clear_frame(j)
                if progress:
                    dt = time.perf_counter() - t0
                    print(f"frame {i}+{step}: {step / max(dt, 1e-9):.1f} FPS", flush=True)
                i += step
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
        self._collect_frame_times(marks)
        kernels.flush_launch_counts()
        self._log_captures(held)

    def _graph_captures(self) -> dict:
        """The capture records of the steady and BA graphs, by kind."""
        graphs = (("steady", self.steady_graph), ("BA", self.ba_graph))
        return {kind: g.captures for kind, g in graphs if g is not None}

    def _log_captures(self, held: dict) -> None:
        """Log the graphs captured since `held` ({kind: captures then}), by
        reason."""
        made = {kind: Counter(c["reason"] for c in caps[held.get(kind, 0):])
                for kind, caps in self._graph_captures().items()}
        made = {kind: dict(n) for kind, n in made.items() if n}
        if made:
            _log.info("graphs captured in this run, by reason: %s", made)

    def device_timeline(self) -> List[dict]:
        """The last graph replays on this front end's card (StampTable.RING
        of them, whole steady frames, BA calls and closure attempts of every
        front end on the card): dicts of graph, frame index, start_ns and
        end_ns on the host clock of torch.profiler's events (a device read;
        none on the CPU)."""
        if self.device.type != "cuda":
            return []
        return Timing.device_timeline(self.device)

    def run_live(self, progress: bool = False) -> int:
        """Consume a live stream (io.live_inputs.LiveRGBDVideo): process
        each frame as the capture thread delivers it, with the default
        per-frame BA drain, until the stream ends or its capacity is
        reached (badslam_tpu/frontend.py:1329-1348). Records each frame's
        time (as `run`), its capture-to-pose lag and the backlog. Returns
        the number of frames processed; a failed capture raises."""
        video = self.video
        marks = []
        i = 0
        while video.wait_for_frame(i):
            self._wait_for_viewer()
            t0 = time.perf_counter()
            self._timed_step(i, lambda: self.process_frame(i), marks)
            done = time.perf_counter()
            self.live_lag_s.append((i, done - video.push_times[i]))
            self.live_backlog.append(video.received - (i + 1))
            video.clear_frame(i)
            if progress:
                print(f"frame {i}: {1.0 / max(done - t0, 1e-9):.1f} FPS", flush=True)
            i += 1
        self._drain_loop_detections()
        self._collect_frame_times(marks)
        kernels.flush_launch_counts()
        return i

    def export_trajectory(self, path: str) -> None:
        q = self.traj_q.cpu().numpy()
        t = self.traj_t.cpu().numpy()
        poses = [se3.SE3(q[i], t[i]) if self.has_pose[i] else None
                 for i in range(len(q))]
        save_tum_trajectory(path, self.video.timestamps, poses)

    def export_point_cloud(self, path: str) -> None:
        """The valid surfels as a binary PLY (positions, normals, colors)."""
        save_ply(path, *self.direct_ba.export_point_cloud())
