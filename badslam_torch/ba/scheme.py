"""DirectBA: the surfel map and keyframes, and the alternating BA scheme.

Counterpart of ``badslam_tpu/ba/scheme.py`` (direct_ba.h:65-550,
direct_ba.cc, direct_ba_alternating.cc:285-738). Per BA iteration, in the
order of BundleAdjustmentAlternating (``_iteration_core`` there):

  surfel creation for newly active keyframes -> surfel activation and
  normals -> surfel positions and descriptors -> surfel merge and
  compaction -> keyframe poses and re-activation -> covisible-active
  propagation.

The iterations stop early when no keyframe is ACTIVE, as the JAX
package's device while_loop does (``_iterations_while``); here the test is
one host read per iteration, the CUDA original's own design. Likewise the
map ops run on the prefix [0, count + room) of the surfel map, with
`count` read once per BA call after the scheme-end compaction and `room`
the most surfels this call can create: entries beyond are invalid, so the
result is that of the whole capacity.

Not here: the multi-device branches, the staged profiling path, the
pow-2 keyframe and surfel buckets (they bound XLA recompiles), and the
intrinsics step (self-calibration is a later slice).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from badslam_torch.ba.geometry_opt import (
    _position_step,
    update_activation_and_normals,
)
from badslam_torch.ba.intrinsics_opt import empty_depth_params
from badslam_torch.ba.pose_opt import optimize_keyframe_poses
from badslam_torch.config import BadSlamConfig
from badslam_torch.geometry import se3
from badslam_torch.mapping import keyframes as kfs
from badslam_torch.mapping import surfels as sf
from badslam_torch.mapping.keyframes import KeyframeStore
from badslam_torch.ops.preprocess import ProcessedFrame

ACTIVE = kfs.ACTIVE
INACTIVE = kfs.INACTIVE
COVISIBLE_ACTIVE = kfs.COVISIBLE_ACTIVE


class DirectBA:
    def __init__(self, cam, config: Optional[BadSlamConfig] = None,
                 surfel_capacity: Optional[int] = None,
                 device: torch.device | str = "cuda"):
        self.config = config or BadSlamConfig()
        self.cam = cam
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is "
                               f"not available")
        cap = surfel_capacity or self.config.max_surfel_count
        self.surfels = sf.empty_map(cap, self.device)
        self.keyframes = KeyframeStore(cam, self.device,
                                       capacity=self.config.keyframe_bucket_base)
        self.ba_iteration_count = 0
        self.last_ba_iteration_count = -1
        # Depth-deformation parameters (identity; self-calibration is a
        # later slice).
        self.depth_params = empty_depth_params(
            cam.height, cam.width, self.config.sparse_surfel_cell_size,
            self.device)
        # Iterations run by each bundle_adjustment call (diagnostics).
        self.iterations_run = []

    # ------------------------------------------------------------------

    @property
    def surfel_count(self) -> int:
        return int(self.surfels.count)

    def add_keyframe(self, frame: ProcessedFrame, global_T_frame: se3.SE3,
                     frame_index: int = -1) -> int:
        return self.keyframes.add_keyframe(frame, global_T_frame, frame_index)

    def min_observation_count(self) -> int:
        """Bootstrapping-aware filter from the host keyframe count."""
        return self.config.min_observation_count_at(self.keyframes.count)

    def _cells_per_keyframe(self) -> int:
        c = self.config.sparse_surfel_cell_size
        return (self.cam.height // c) * (self.cam.width // c)

    def _working_map(self, new_keyframes: int) -> sf.SurfelMap:
        """The prefix [0, count + room) of the map, room being what
        `new_keyframes` keyframes can create (one surfel per cell each)."""
        size = self.surfel_count + new_keyframes * self._cells_per_keyframe()
        return sf.prefix(self.surfels, min(size, self.surfels.capacity))

    # ------------------------------------------------------------------
    # Surfel lifecycle
    # ------------------------------------------------------------------

    def create_surfels_for_keyframe(self, kf_id: int,
                                    filter_new_surfels: bool = True) -> torch.Tensor:
        """Create surfels for one keyframe slot (the first keyframe's
        bootstrap). Returns the number created as a device scalar."""
        view = self._working_map(1)
        view, created = self._create_surfels(view, [kf_id], filter_new_surfels)
        self.surfels = sf.write_back(self.surfels, view)
        return created

    def _create_surfels(self, smap, ids, filter_new_surfels=True):
        ks = self.keyframes
        c = self.config
        return sf.create_surfels_for_keyframes(
            smap, self.cam, ks.stack(), ids, ks.covis,
            self.min_observation_count(), baseline_fx=c.baseline_fx,
            cell_size=c.sparse_surfel_cell_size,
            filter_new_surfels=filter_new_surfels, rgb_stack=ks.rgb)

    def _merge_surfels(self, smap, ids):
        c = self.config
        return sf.merge_surfels_for_keyframes(
            smap, self.cam, self.keyframes.stack(), ids,
            baseline_fx=c.baseline_fx, cell_size=c.sparse_surfel_cell_size,
            merge_dist_factor=c.surfel_merge_dist_factor)

    def _scheme_end_tasks(self, smap, do_surfel_updates: bool):
        """PerformBASchemeEndTasks (direct_ba.cc:566-653): a final merge
        over this epoch's active keyframes, then delete and compact."""
        ks = self.keyframes
        k = ks.count
        with record_function("ba/scheme_end"):
            if do_surfel_updates:
                recently_active = ks.valid[:k] & (
                    ks.last_active_iter[:k] == self.ba_iteration_count)
                smap = self._merge_surfels(
                    smap, torch.nonzero(recently_active).flatten().tolist())
            smap = sf.delete_surfels_and_update_radii(
                smap, self.cam, ks.stack(), self.min_observation_count(),
                baseline_fx=self.config.baseline_fx)
            return sf.compact_surfels(smap)

    def perform_ba_scheme_end_tasks(self, do_surfel_updates: bool = True) -> None:
        if self.keyframes.count == 0:
            return
        view = self._scheme_end_tasks(self._working_map(0), do_surfel_updates)
        self.surfels = sf.write_back(self.surfels, view)

    # ------------------------------------------------------------------
    # The alternating BA scheme
    # ------------------------------------------------------------------

    def _iteration(self, smap, activate_all: bool, optimize_geometry: bool,
                   do_surfel_updates: bool, optimize_poses: bool):
        """One alternating-BA iteration (direct_ba_alternating.cc:345-626);
        updates the keyframe store in place and returns the map."""
        c = self.config
        ks = self.keyframes
        k = ks.count
        valid = ks.valid[:k]
        activation = ks.activation[:k]
        if activate_all:
            activation = torch.where(valid, ACTIVE, INACTIVE)
        ba_iter = self.ba_iteration_count
        la = ks.last_active_iter[:k]
        lc = ks.last_covis_iter[:k]
        newly_active = valid & (activation == ACTIVE) & (la != ba_iter)
        newly_covis = valid & (activation == COVISIBLE_ACTIVE) & (lc != ba_iter)
        ks.last_active_iter[:k] = torch.where(newly_active, ba_iter, la)
        ks.last_covis_iter[:k] = torch.where(newly_covis, ba_iter, lc)
        create_ids = torch.nonzero(newly_active).flatten().tolist()

        full_stack = ks.stack()
        if optimize_geometry and do_surfel_updates:
            with record_function("ba/create"):
                smap, _ = self._create_surfels(smap, create_ids)

        active_strict = valid & (activation == ACTIVE)
        participating = valid & ((activation == ACTIVE)
                                 | (activation == COVISIBLE_ACTIVE))
        kstack = full_stack._replace(mask=participating)
        with record_function("ba/activation_normals"):
            smap = update_activation_and_normals(
                smap, self.cam, full_stack, active_strict, participating,
                baseline_fx=c.baseline_fx, update_normals=optimize_geometry)
        if optimize_geometry:
            with record_function("ba/position"):
                smap = _position_step(
                    smap, self.cam, kstack, baseline_fx=c.baseline_fx,
                    use_depth=c.use_geometric_residuals,
                    use_descriptor=c.use_photometric_residuals)
        if do_surfel_updates:
            with record_function("ba/merge_compact"):
                smap = self._merge_surfels(smap, create_ids)
                smap = sf.compact_surfels(smap)

        if optimize_poses:
            with record_function("ba/poses"):
                result = optimize_keyframe_poses(
                    smap, self.cam, kstack, baseline_fx=c.baseline_fx,
                    use_depth=c.use_geometric_residuals,
                    use_descriptor=c.use_photometric_residuals,
                    max_iterations=30)
            ks.q[:k] = torch.where(participating[:, None], result.q, ks.q[:k])
            ks.t[:k] = torch.where(participating[:, None], result.t, ks.t[:k])
            activation = torch.where(
                participating, torch.where(result.moved, ACTIVE, INACTIVE),
                activation)
        ks.activation[:k] = kfs.propagate_covisible_active(
            ks.covis[:k, :k], activation, valid)
        return smap

    def bundle_adjustment(self, optimize_poses: bool = True,
                          optimize_geometry: bool = True,
                          do_surfel_updates: bool = True,
                          max_iterations: int = 10,
                          increase_ba_iteration_count: bool = True,
                          activate_all: Optional[bool] = None,
                          optimize_depth_intrinsics: bool = False,
                          optimize_color_intrinsics: bool = False,
                          active_keyframe_window=None) -> int:
        """Run up to `max_iterations` iterations of the alternating scheme,
        stopping early when no keyframe is ACTIVE. Returns the number of
        iterations run.

        `activate_all` (default: config.disable_deactivation without a
        window) re-activates every valid keyframe at the start of each
        iteration, the reference's default (bad_slam.cc:268-269 ->
        direct_ba_alternating.cc:355-372). With `active_keyframe_window`
        (lo, hi), the final BA's fixed window (main.cc:765-789), each
        iteration activates the valid slots lo..hi and their covisible
        keyframes, and all `max_iterations` run (the JAX package's host
        loop, which has no early exit without sync_convergence_checks). With
        `increase_ba_iteration_count` false (the parallel-BA drain) the
        scheme-end tasks of the previous epoch run first when the epoch has
        changed, and none run at the end."""
        if optimize_depth_intrinsics or optimize_color_intrinsics:
            raise NotImplementedError(
                "badslam_torch: intrinsics optimization comes with the "
                "self-calibration slice")
        ks = self.keyframes
        k = ks.count
        if k == 0:
            return 0
        fixed_window = active_keyframe_window is not None
        if activate_all is None:
            activate_all = self.config.disable_deactivation and not fixed_window

        # Each valid keyframe creates surfels at most once per epoch: those
        # not yet active in this one bound what the call can create.
        new_keyframes = int((ks.valid[:k] & (
            ks.last_active_iter[:k] != self.ba_iteration_count)).sum())
        smap = self._working_map(new_keyframes)

        if (not increase_ba_iteration_count
                and self.ba_iteration_count != self.last_ba_iteration_count):
            self.last_ba_iteration_count = self.ba_iteration_count
            smap = self._scheme_end_tasks(smap, do_surfel_updates)

        # Reset the surfel active flags for this BA block
        # (direct_ba_alternating.cc:338).
        smap = smap._replace(active=torch.zeros_like(smap.active))

        if activate_all:
            # The early-exit test runs before the first iteration; with the
            # activate-all window every valid keyframe enters it active.
            ks.activation[:k] = torch.where(ks.valid[:k], ACTIVE, INACTIVE)
        iterations = 0
        while iterations < max_iterations and (fixed_window or bool(
                (ks.valid[:k] & (ks.activation[:k] == ACTIVE)).any())):
            if fixed_window:
                ks.set_activation_window(*active_keyframe_window)
                ks.propagate_covisible_active()
            smap = self._iteration(smap, activate_all, optimize_geometry,
                                   do_surfel_updates, optimize_poses)
            iterations += 1

        if increase_ba_iteration_count:
            smap = self._scheme_end_tasks(smap, do_surfel_updates)
            self.ba_iteration_count += 1
        self.surfels = sf.write_back(self.surfels, smap)
        self.iterations_run.append(iterations)
        return iterations

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def export_point_cloud(self, refresh_colors: bool = True):
        """(positions, normals, colors) numpy arrays of the valid surfels
        (ExportToPointCloud, direct_ba.cc:461-547). With refresh_colors each
        surfel's color is first averaged over all its keyframe observations
        (AssignColorsCUDA)."""
        ks = self.keyframes
        if refresh_colors and ks.count > 0:
            view = sf.assign_colors(self._working_map(0), self.cam, ks.stack(),
                                    ks.rgb[:ks.count],
                                    baseline_fx=self.config.baseline_fx)
            self.surfels = sf.write_back(self.surfels, view)
        m = self.surfels
        valid = m.valid.cpu().numpy()
        return (m.pos.cpu().numpy()[valid], m.normal.cpu().numpy()[valid],
                m.color.cpu().numpy()[valid])
