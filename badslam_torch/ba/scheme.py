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

With intrinsics optimization (self-calibration) the JAX package leaves
its fused program for its host loop: every one of the `max_iterations`
iterations runs (no early exit) and is followed by the intrinsics step
(``optimize_intrinsics_step``), which updates the camera and the depth
deformation and re-derives the keyframes' planes; the port does the same.
The PCG solver (``ba/pcg.py``) works on this same state.

Multi-device BA (``config.n_devices > 1``, or an explicit ``mesh``): the
canonical map and keyframe store stay on ``device``; each BA call splits
its working prefix into D row blocks over the mesh and writes them back at
the end (the JAX package's per-call device_put of its working slice), and
runs every stage through ``parallel/streamed.py``. The keyframe planes are
replicated to each device of the mesh, or, when replicating them would
exceed ``plane_replication_budget_mb`` (``_plane_streaming_wanted``, the
JAX package's host-only formula), streamed: shard i holds the slots
[i K/D, (i+1) K/D) of the K-slot store. Either way a block on the store's
own device is a view of its tensors and one elsewhere a copy, refreshed at
the next call for the slots whose planes changed, and rebuilt when the
store grows (the slots' owners change). Both layouts keep the one-device
iteration structure, the early exit included; the JAX package's streamed
mode runs every iteration instead, only because its early exit lives
inside its fused one-device program (a deviation there). The calls the
JAX package sends through its host loop (the fixed window of the final
BA, self-calibration) and the PCG solver run on ``device`` with the whole
map, as without a mesh; their results are the same either way.

With ``config.sync_stage_profiling`` each iteration runs as timed stages,
each ended by a device synchronization, so each stage's timer holds its time
on the card (``utils/timing.py``): surfel creation, surfel activation,
geometry optimization, surfel merge, surfel compaction and pose
optimization. Every one of the `max_iterations` iterations then runs (no
early exit), as in the JAX package's staged host loop. The stages run the
unflagged iteration's passes: activation and the normals are one pass
(``update_activation_and_normals``; on a mesh, activation and the whole
geometry step, ``parallel.activation_geometry_streamed``), so with geometry
optimization that pass is timed with the positions as geometry
optimization, beside an empty surfel-activation stage that keeps the JAX
package's row keys. The JAX package times the normals as geometry
optimization too (``optimize_geometry_iteration``); only activation moves.

``set_save_timings(stream)`` writes the JAX package's timing rows to a
text stream (SetSaveTimings, direct_ba.h:382; direct_ba_alternating.cc:
630-688): under ``sync_stage_profiling``, per iteration a header
``BA_count <n> inner_iteration <i> keyframe_count <k> surfel_bound <b>``
and one ``<stage> <ms>`` row per stage run; otherwise one row per call that
the JAX package runs as its fused program (no keyframe window, no
self-calibration, planes not streamed), ``BA_count <n> fused_iterations
<max_iterations> keyframe_count <k> surfel_bound <b> sync_ms <ms>``, where
``sync_ms`` is the host's wait in a device synchronization at the end of
the iterations (the JAX package's block_until_ready) and
``fused_iterations`` the call's budget, as there. ``surfel_bound`` is the
row count of the call's working map, where the JAX package writes its
pow-2 surfel bucket: both bound the surfel count, but they differ.

Not here: the pow-2 keyframe and surfel buckets (they bound XLA
recompiles).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
from torch.profiler import record_function

from badslam_torch import parallel
from badslam_torch.ba.geometry_opt import (
    _position_step,
    update_activation_and_normals,
)
from badslam_torch.ba.intrinsics_opt import empty_depth_params, optimize_intrinsics
from badslam_torch.ba.pose_opt import optimize_keyframe_poses
from badslam_torch.config import BadSlamConfig
from badslam_torch.geometry import se3
from badslam_torch.mapping import keyframes as kfs
from badslam_torch.mapping import surfels as sf
from badslam_torch.mapping.keyframes import KeyframeStore
from badslam_torch.ops.preprocess import ProcessedFrame
from badslam_torch.utils.timing import Spans, Timing

ACTIVE = kfs.ACTIVE
INACTIVE = kfs.INACTIVE
COVISIBLE_ACTIVE = kfs.COVISIBLE_ACTIVE


def _timer(name: Optional[str], device: torch.device):
    """The Timing region `name` of `device`'s work, or none for None."""
    return contextlib.nullcontext() if name is None else Timing.time(name, device=device)


class DirectBA:
    def __init__(self, cam, config: Optional[BadSlamConfig] = None,
                 surfel_capacity: Optional[int] = None,
                 device: torch.device | str = "cuda",
                 mesh: Optional[parallel.Mesh] = None):
        self.config = config or BadSlamConfig()
        self.cam = cam
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is "
                               f"not available")
        # The device mesh of multi-device BA: given, or n_devices shards
        # (cuda:0..n-1 on CUDA, raising when fewer cards are visible).
        n = self.config.n_devices
        if mesh is not None and n > 1 and mesh.size != n:
            raise ValueError(f"a mesh of {mesh.size} shards for config.n_devices={n}")
        if mesh is None and n > 1:
            mesh = parallel.make_mesh(n, self.device)
        self.mesh = mesh
        # The keyframe planes over the mesh, and whether the last BA call
        # streamed them.
        self._planes = None
        self._streaming = False
        cap = surfel_capacity or self.config.max_surfel_count
        self.surfels = sf.empty_map(cap, self.device)
        self.keyframes = KeyframeStore(cam, self.device,
                                       capacity=self.config.keyframe_bucket_base)
        self.ba_iteration_count = 0
        self.last_ba_iteration_count = -1
        # Depth-deformation parameters (DepthParameters analog), identity
        # until self-calibration updates them.
        self.depth_params = empty_depth_params(
            cam.height, cam.width, self.config.sparse_surfel_cell_size,
            self.device)
        # Set when self-calibration changed `cam`; the front end refreshes
        # its cameras and clears it.
        self.intrinsics_updated = False
        # Diagnostics: iterations run by each BA call (alternating or PCG),
        # the CG steps of each PCG outer iteration, and the elapsed time of
        # each intrinsics step and each PCG outer iteration.
        self.iterations_run = []
        self.cg_steps = []
        self.intrinsics_spans = Spans(self.device)
        self.pcg_spans = Spans(self.device)
        # Elapsed time of each bundle_adjustment call.
        self.ba_spans = Spans(self.device)
        # The text stream of the timing rows (set_save_timings).
        self.timings_stream = None

    def set_save_timings(self, stream) -> None:
        self.timings_stream = stream

    def _synchronize(self) -> None:
        """Wait for the BA work queued on this device and the mesh's."""
        devices = [self.device] + (self.mesh.distinct() if self.mesh is not None else [])
        for d in dict.fromkeys(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    @contextlib.contextmanager
    def _stage(self, name: str):
        """One BA stage: under sync_stage_profiling its timer, ended by a
        device synchronization (of every device of the mesh), and its
        timing row; else untimed."""
        if not self.config.sync_stage_profiling:
            yield
            return
        with Timing.time(name, sync=self.device) as span:
            yield
            self._synchronize()
        if self.timings_stream is not None:
            self.timings_stream.write(f"{name.replace(' ', '_')} {span.ms:.3f}\n")

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

    # ------------------------------------------------------------------
    # Multi-device state
    # ------------------------------------------------------------------

    def _plane_streaming_wanted(self) -> bool:
        """True when the mesh should stream the keyframe planes instead of
        replicating them: their replicated footprint (f32 depth, nx, ny,
        radius2, intensity and u8 rgb per pixel) exceeds
        plane_replication_budget_mb, and the keyframe and surfel capacities
        divide over the mesh (badslam_tpu/ba/scheme.py:489, host-only)."""
        if self.mesh is None:
            return False
        n = self.mesh.size
        ks = self.keyframes
        if ks.capacity % n != 0 or self.surfels.capacity % n != 0:
            return False
        mb = ks.capacity * self.cam.height * self.cam.width * 23 / 1e6
        return mb > self.config.plane_replication_budget_mb

    def mesh_planes(self, streamed: bool) -> parallel.Planes:
        """The keyframe planes over the mesh: rebuilt when the store, its
        storage or the layout changed, else refreshed for the slots whose
        planes were written since the last call."""
        ks = self.keyframes
        p = self._planes
        if p is None or not p.built_from(ks, streamed):
            self._planes = parallel.Planes.of_store(self.mesh, ks, streamed)
        elif ks.changed_slots:
            p.refresh(ks.changed_slots)
        ks.changed_slots.clear()
        return self._planes

    # ------------------------------------------------------------------
    # Stages: one device, or the mesh when the map is a ShardedMap
    # ------------------------------------------------------------------

    def _create_surfels(self, smap, ids, filter_new_surfels=True):
        ks = self.keyframes
        c = self.config
        if isinstance(smap, parallel.ShardedMap):
            k = ks.count
            return parallel.create_surfels_streamed(
                self.mesh, smap, self.cam, self._planes, ks.q[:k], ks.t[:k], ids,
                ks.covis, ks.valid, self.min_observation_count(),
                baseline_fx=c.baseline_fx, cell_size=c.sparse_surfel_cell_size,
                filter_new_surfels=filter_new_surfels)
        return sf.create_surfels_for_keyframes(
            smap, self.cam, ks.stack(), ids, ks.covis,
            self.min_observation_count(), baseline_fx=c.baseline_fx,
            cell_size=c.sparse_surfel_cell_size,
            filter_new_surfels=filter_new_surfels, rgb_stack=ks.rgb)

    def _merge_surfels(self, smap, ids):
        c = self.config
        if isinstance(smap, parallel.ShardedMap):
            ks = self.keyframes
            return parallel.merge_surfels_streamed(
                self.mesh, smap, self.cam, self._planes, ks.q[:ks.count],
                ks.t[:ks.count], ids, baseline_fx=c.baseline_fx,
                cell_size=c.sparse_surfel_cell_size,
                merge_dist_factor=c.surfel_merge_dist_factor)
        return sf.merge_surfels_for_keyframes(
            smap, self.cam, self.keyframes.stack(), ids,
            baseline_fx=c.baseline_fx, cell_size=c.sparse_surfel_cell_size,
            merge_dist_factor=c.surfel_merge_dist_factor)

    def _compact(self, smap):
        if isinstance(smap, parallel.ShardedMap):
            return parallel.compact_surfels_streamed(self.mesh, smap)
        return sf.compact_surfels(smap)

    def _delete_surfels(self, smap):
        ks = self.keyframes
        k = ks.count
        c = self.config
        if isinstance(smap, parallel.ShardedMap):
            return parallel.delete_surfels_streamed(
                self.mesh, smap, self.cam, self._planes, ks.q[:k], ks.t[:k],
                ks.valid[:k], self.min_observation_count(),
                baseline_fx=c.baseline_fx)
        return sf.delete_surfels_and_update_radii(
            smap, self.cam, ks.stack(), self.min_observation_count(),
            baseline_fx=c.baseline_fx)

    def _geometry(self, smap, active_strict, participating, optimize_geometry):
        """Surfel activation and normals, then (with optimize_geometry) the
        positions and descriptors over the participating keyframes. With
        optimize_geometry activation and normals are one pass, timed with
        the positions as geometry optimization, beside an empty activation
        stage (the module docstring)."""
        c = self.config
        ks = self.keyframes
        k = ks.count
        if optimize_geometry:
            with self._stage("BA surfel activation"):
                pass  # fused into the geometry stage's pass
        with self._stage("BA geometry optimization" if optimize_geometry
                         else "BA surfel activation"):
            if isinstance(smap, parallel.ShardedMap):
                with record_function("ba/activation_geometry"):
                    return parallel.activation_geometry_streamed(
                        self.mesh, smap, self.cam, self._planes, ks.q[:k], ks.t[:k],
                        active_strict, participating, baseline_fx=c.baseline_fx,
                        use_depth=c.use_geometric_residuals,
                        use_descriptor=c.use_photometric_residuals,
                        optimize_geometry=optimize_geometry)
            full_stack = ks.stack()
            with record_function("ba/activation_normals"):
                smap = update_activation_and_normals(
                    smap, self.cam, full_stack, active_strict, participating,
                    baseline_fx=c.baseline_fx, update_normals=optimize_geometry)
            if optimize_geometry:
                with record_function("ba/position"):
                    smap = _position_step(
                        smap, self.cam, full_stack._replace(mask=participating),
                        baseline_fx=c.baseline_fx,
                        use_depth=c.use_geometric_residuals,
                        use_descriptor=c.use_photometric_residuals)
        return smap

    def _poses(self, smap, participating):
        c = self.config
        ks = self.keyframes
        k = ks.count
        if isinstance(smap, parallel.ShardedMap):
            return parallel.optimize_poses_streamed(
                self.mesh, smap, self.cam, self._planes, ks.q[:k], ks.t[:k],
                participating, baseline_fx=c.baseline_fx,
                use_depth=c.use_geometric_residuals,
                use_descriptor=c.use_photometric_residuals, max_iterations=30)
        return optimize_keyframe_poses(
            smap, self.cam, ks.stack()._replace(mask=participating),
            baseline_fx=c.baseline_fx, use_depth=c.use_geometric_residuals,
            use_descriptor=c.use_photometric_residuals, max_iterations=30)

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
            return self._compact(self._delete_surfels(smap))

    def _split(self, view):
        """The working view over the mesh (planes brought up to date), or
        the view itself without a mesh."""
        if self.mesh is None:
            return view
        self._streaming = self._plane_streaming_wanted()
        self.mesh_planes(self._streaming)
        return parallel.shard_rows(self.mesh, view)

    def _join(self, smap):
        if isinstance(smap, parallel.ShardedMap):
            return parallel.gather_rows(self.mesh, smap, self.device)
        return smap

    def perform_ba_scheme_end_tasks(self, do_surfel_updates: bool = True) -> None:
        if self.keyframes.count == 0:
            return
        view = self._scheme_end_tasks(self._split(self._working_map(0)),
                                      do_surfel_updates)
        self.surfels = sf.write_back(self.surfels, self._join(view))

    # ------------------------------------------------------------------
    # Intrinsics / self-calibration
    # ------------------------------------------------------------------

    def _intrinsics_step(self, smap, optimize_depth: bool, optimize_color: bool) -> None:
        ks = self.keyframes
        c = self.config
        with self.intrinsics_spans.span(), record_function("ba/intrinsics"):
            self.cam, self.depth_params = optimize_intrinsics(
                smap, self.cam, ks.stack(), ks.stack_raw(), self.depth_params,
                baseline_fx=c.baseline_fx, cell_size=c.sparse_surfel_cell_size,
                optimize_depth=optimize_depth, optimize_color=optimize_color)
            if optimize_depth:
                ks.recalibrate(self.cam, self.depth_params.a,
                               self.depth_params.cfactor, c.sparse_surfel_cell_size)
        self.intrinsics_updated = True

    def optimize_intrinsics_step(self, optimize_depth_intrinsics: bool = True,
                                 optimize_color_intrinsics: bool = False) -> None:
        """One Schur-complement intrinsics step over the valid keyframes and
        the map: updates `cam` and `depth_params` and re-derives the
        keyframes' calibrated planes when the depth intrinsics moved."""
        if self.keyframes.count == 0:
            return
        self._intrinsics_step(self._working_map(0), optimize_depth_intrinsics,
                              optimize_color_intrinsics)

    # ------------------------------------------------------------------
    # The alternating BA scheme
    # ------------------------------------------------------------------

    def _iteration(self, smap, activate_all: bool, optimize_geometry: bool,
                   do_surfel_updates: bool, optimize_poses: bool):
        """One alternating-BA iteration (direct_ba_alternating.cc:345-626);
        updates the keyframe store in place and returns the map. Each stage
        runs in `_stage`, by its JAX timer name."""
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

        if optimize_geometry and do_surfel_updates:
            with self._stage("BA surfel creation"), record_function("ba/create"):
                smap, _ = self._create_surfels(smap, create_ids)

        active_strict = valid & (activation == ACTIVE)
        participating = valid & ((activation == ACTIVE)
                                 | (activation == COVISIBLE_ACTIVE))
        smap = self._geometry(smap, active_strict, participating, optimize_geometry)
        if do_surfel_updates:
            with record_function("ba/merge_compact"):
                with self._stage("BA surfel merge"):
                    smap = self._merge_surfels(smap, create_ids)
                with self._stage("BA surfel compaction"):
                    smap = self._compact(smap)

        if optimize_poses:
            with self._stage("BA pose optimization"):
                with record_function("ba/poses"):
                    result = self._poses(smap, participating)
                ks.set_poses(result.q, result.t, participating)
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

        With `optimize_depth_intrinsics` / `optimize_color_intrinsics` every
        iteration runs and is followed by the intrinsics step (the JAX
        package's host loop), each system gated by its residual kind
        (use_geometric_residuals / use_photometric_residuals). Under
        config.sync_stage_profiling every iteration runs too, stage by stage
        (the module docstring).

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
        if self.keyframes.count == 0:
            return 0
        fixed_window = active_keyframe_window is not None
        if activate_all is None:
            activate_all = self.config.disable_deactivation and not fixed_window

        with self.ba_spans.span():
            iterations = self._bundle_adjustment(
                optimize_poses, optimize_geometry, do_surfel_updates,
                max_iterations, increase_ba_iteration_count, activate_all,
                optimize_depth_intrinsics, optimize_color_intrinsics,
                active_keyframe_window)
        self.iterations_run.append(iterations)
        return iterations

    def _bundle_adjustment(self, optimize_poses, optimize_geometry,
                           do_surfel_updates, max_iterations,
                           increase_ba_iteration_count, activate_all,
                           optimize_depth_intrinsics, optimize_color_intrinsics,
                           active_keyframe_window) -> int:
        c = self.config
        ks = self.keyframes
        k = ks.count
        fixed_window = active_keyframe_window is not None
        intrinsics = optimize_depth_intrinsics or optimize_color_intrinsics
        # Each valid keyframe creates surfels at most once per epoch: those
        # not yet active in this one bound what the call can create.
        new_keyframes = int((ks.valid[:k] & (
            ks.last_active_iter[:k] != self.ba_iteration_count)).sum())
        smap = self._working_map(new_keyframes)
        bound = smap.valid.shape[0]  # the rows' surfel_bound
        # The JAX package's host-loop calls (every iteration runs) keep the
        # whole map on this device.
        host_loop = fixed_window or intrinsics
        if not host_loop:
            smap = self._split(smap)

        if (not increase_ba_iteration_count
                and self.ba_iteration_count != self.last_ba_iteration_count):
            self.last_ba_iteration_count = self.ba_iteration_count
            smap = self._scheme_end_tasks(smap, do_surfel_updates)

        # Reset the surfel active flags for this BA block
        # (direct_ba_alternating.cc:338).
        if isinstance(smap, parallel.ShardedMap):
            smap = smap._replace(shards=tuple(
                s._replace(active=torch.zeros_like(s.active)) for s in smap.shards))
        else:
            smap = smap._replace(active=torch.zeros_like(smap.active))

        if activate_all:
            # The early-exit test runs before the first iteration; with the
            # activate-all window every valid keyframe enters it active.
            ks.activation[:k] = torch.where(ks.valid[:k], ACTIVE, INACTIVE)
        # Staged profiling is one of the JAX package's host-loop modes too:
        # every iteration runs there, with the stages timed one by one. The
        # other calls are its fused program, timed as one region.
        staged = c.sync_stage_profiling
        fused = None
        if not (host_loop or staged):
            fused = ("BA iterations (streamed)" if isinstance(smap, parallel.ShardedMap)
                     and self._streaming else "BA iterations (fused)")
        iteration_timer = "BA iteration" if host_loop and not staged else None
        iterations = 0
        with _timer(fused, self.device):
            while iterations < max_iterations and (host_loop or staged or bool(
                    (ks.valid[:k] & (ks.activation[:k] == ACTIVE)).any())):
                if fixed_window:
                    ks.set_activation_window(*active_keyframe_window)
                    ks.propagate_covisible_active()
                if staged and self.timings_stream is not None:
                    self.timings_stream.write(
                        f"BA_count {self.ba_iteration_count} inner_iteration "
                        f"{iterations} keyframe_count {ks.live_count} "
                        f"surfel_bound {bound}\n")
                with _timer(iteration_timer, self.device):
                    smap = self._iteration(smap, activate_all, optimize_geometry,
                                           do_surfel_updates, optimize_poses)
                iterations += 1
                if intrinsics:
                    with Timing.time("BA intrinsics optimization",
                                     sync=self.device if staged else None,
                                     device=self.device):
                        self._intrinsics_step(
                            smap, optimize_depth_intrinsics and c.use_geometric_residuals,
                            optimize_color_intrinsics and c.use_photometric_residuals)
        if fused == "BA iterations (fused)" and self.timings_stream is not None:
            t0 = time.perf_counter()
            self._synchronize()
            self.timings_stream.write(
                f"BA_count {self.ba_iteration_count} fused_iterations {max_iterations} "
                f"keyframe_count {ks.live_count} surfel_bound {bound} "
                f"sync_ms {1e3 * (time.perf_counter() - t0):.3f}\n")

        if increase_ba_iteration_count:
            smap = self._scheme_end_tasks(smap, do_surfel_updates)
            self.ba_iteration_count += 1
        self.surfels = sf.write_back(self.surfels, self._join(smap))
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
