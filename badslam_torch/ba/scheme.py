"""DirectBA: the surfel map and keyframes, and the alternating BA scheme.

Counterpart of ``badslam_tpu/ba/scheme.py`` (direct_ba.h:65-550,
direct_ba.cc, direct_ba_alternating.cc:285-738). Per BA iteration, in the
order of BundleAdjustmentAlternating (``_iteration_core`` there and here):

  surfel creation for newly active keyframes -> surfel activation and
  normals -> surfel positions and descriptors -> surfel merge and
  compaction -> keyframe poses and re-activation -> covisible-active
  propagation.

The fused call. Every BA call that the JAX package runs as one program
(no keyframe window, no self-calibration, no staged profiling), on one
device or over a mesh (below), runs here as one function of the map and
keyframe state, ``_fused_program``
(the JAX package's ``_ba_iterations`` / ``_ba_iterations_bucketed`` with
its ``_scheme_end_tasks``): the previous epoch's scheme-end tasks when a
drain starts a new epoch, the reset of the surfel active flags, the
iterations, and on a keyframe call the epoch-ending scheme-end tasks. The
iterations run while "fewer than max_iterations and any keyframe ACTIVE"
(``_iterations_while`` there), with every valid keyframe ACTIVE on entry
under the activate-all window. Which keyframes create, merge and optimize
is a device mask, and every loop (the iterations, creation and merge per
slot, each keyframe block's Gauss-Newton loop) runs under a loop control
(``ops.conditional``): on the CPU and in the card's eager call the host
loop, which reads each loop's flag back; the masked plain version, which
reads nothing (for tests); or, captured as one CUDA graph per call on the
card (``ba/graph.py``), WHILE nodes, so the card decides every exit and a
call reads nothing back. ``max_iterations``, the epoch
(``ba_iteration_count``) and the bootstrapping-aware
``min_observation_count`` are device scalars there, so one graph serves
every drain length.

The buckets, as in the JAX package. The call works on the pow-2 keyframe
bucket (``_keyframe_bucket``: the live slots first, padded with distinct
dead slots, from ``keyframe_bucket_base`` with a high-water mark; the whole
capacity when it would exceed half of it), gathered from the store at the
start of the call and scattered back at its end, and on the prefix
[0, bucket) of the surfel map, the pow-2 bucket of the host-known surfel
bound (``_bucket_size`` from ``surfel_bucket_base``). The bound,
``known_surfel_bound``, grows by count * cells once per BA epoch (each
valid keyframe creates surfels at most once per epoch), is pre-sized for a
dataset of known length (``prebudget_epochs``) and, with
``sync_surfel_bucket``, re-synced from one read of the surfel count after
an epoch-ending call: the only read of a BA call. The bucket is taken of
the larger of that bound and the same bound without the pre-sizing
(``_creation_bound``): the JAX package stops growing the bound over the
pre-sized epochs even after a re-sync has lowered it, and the map's rows
beyond the bucket would then drop surfels that creation makes; here the
bucket always holds the count plus what the call can create, so rows
beyond it are invalid and the result is that of the whole map.

The host loop stays, as in the JAX package, for the final BA's fixed
window, self-calibration and ``sync_stage_profiling``: ``_iteration`` runs
one iteration on the store's slots [0, count) with the host controls.

With intrinsics optimization (self-calibration) every one of the
`max_iterations` iterations runs (no early exit) and is followed by the
intrinsics step (``optimize_intrinsics_step``), which updates the camera
and the depth deformation and re-derives the keyframes' planes. The PCG
solver (``ba/pcg.py``) works on this same state.

Multi-device BA (``config.n_devices > 1``, or an explicit ``mesh``): the
canonical map and keyframe store stay on ``device``. A fused call over the
mesh is the same ``_fused_program``: it splits its surfel bucket into D row
blocks over the mesh (``parallel.shard_rows``, the JAX package's
``P("d")`` over its sliced map), runs every stage through
``parallel/streamed.py`` with the call's masks and its loop control, and
writes the rows back into the map's storage at the end, so it reads
nothing back and captures as one CUDA graph per call (``ba/graph.py``)
when every shard is on the one card. The keyframe planes are replicated
to each device of the mesh, or, when replicating them would exceed
``plane_replication_budget_mb`` (``_plane_streaming_wanted``, the JAX
package's host-only formula), streamed: shard i holds the slots
[i K/D, (i+1) K/D) of the K-slot store. Either way a block on the store's
own device is a view of its tensors and one elsewhere a copy, refreshed
on the host before the next call for the slots whose planes changed, and
rebuilt when the store grows (the slots' owners change). Replicated
planes take the keyframe bucket, as the one-device call does (the JAX
package's ``_ba_iterations_bucketed`` over the mesh); streamed ones the
whole capacity, as the JAX package's ``_run_iterations_streamed`` (its
rows are the slots the shards hold), timed as ``BA iterations
(streamed)`` and without the fused timing row. Both keep the one-device
iteration structure, the early exit included (in the graph, the
iterations' WHILE node); the JAX package's streamed mode runs every
iteration instead, only because its early exit lives inside its fused
one-device program (a deviation there). The calls the JAX package sends
through its host loop (the fixed window of the final BA, self-calibration)
and the PCG solver run on ``device`` with the whole map, as without a
mesh; ``sync_stage_profiling`` runs its stages over the mesh on the
surfel bucket.

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
and one ``<stage> <ms>`` row per stage run; otherwise one row per fused
call, ``BA_count <n> fused_iterations <max_iterations> keyframe_count <k>
surfel_bound <b> sync_ms <ms>``, where ``sync_ms`` is the host's wait in a
device synchronization at the end of the call (the JAX package's
block_until_ready) and ``fused_iterations`` the call's budget, as there.
``surfel_bound`` is ``known_surfel_bound``, the JAX package's value.

``iterations_run`` lists the iterations of each call; a graph replay's
count stays on the card until the list is read (a device read, for
reports).
"""

from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple, Optional, Union

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
from badslam_torch.mapping.keyframes import KeyframeStack, KeyframeStore
from badslam_torch.ops.conditional import HOST, Control, loop
from badslam_torch.ops.preprocess import ProcessedFrame
from badslam_torch.utils.timing import Spans, Timing, capturing, count, stamped, trace_range

ACTIVE = kfs.ACTIVE
INACTIVE = kfs.INACTIVE
COVISIBLE_ACTIVE = kfs.COVISIBLE_ACTIVE


def _timer(name: Optional[str], device: torch.device):
    """The Timing region `name` of `device`'s work, or none for None."""
    return contextlib.nullcontext() if name is None else Timing.time(name, device=device)


def _without_active(smap):
    """The map (every shard of a mesh's) with its active flags cleared."""
    if isinstance(smap, parallel.ShardedMap):
        return smap._replace(shards=tuple(_without_active(s) for s in smap.shards))
    return smap._replace(active=torch.zeros_like(smap.active))


def _flat(smap) -> tuple:
    """A map's tensors (every shard's over a mesh) as a loop's state."""
    if isinstance(smap, parallel.ShardedMap):
        return parallel.streamed.flat(smap)
    return tuple(smap)


def _unflat(like, state):
    """The map of `_flat`'s tuple, laid out as `like`."""
    if isinstance(like, parallel.ShardedMap):
        return parallel.streamed.unflat(like, state)
    return sf.SurfelMap(*state)


class Slots(NamedTuple):
    """The keyframe state a BA call works on: views of the store's slots
    [0, n), or the keyframe bucket gathered from it."""

    depth: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    radius2: torch.Tensor
    intensity: torch.Tensor
    rgb: torch.Tensor
    q: torch.Tensor
    t: torch.Tensor
    valid: torch.Tensor
    activation: torch.Tensor
    last_active: torch.Tensor
    last_covis: torch.Tensor
    covis: torch.Tensor  # [n, n]
    ids: Optional[torch.Tensor] = None  # the store slot of each row (None: row = slot)

    def stack(self, q, t, mask) -> KeyframeStack:
        return KeyframeStack(self.depth, self.nx, self.ny, self.radius2,
                             self.intensity, q, t, mask)


# The fields of Slots that a BA call writes, in the iteration state's order.
_SLOT_STATE = ("q", "t", "activation", "last_active", "last_covis")
_STORE_FIELD = {"q": "q", "t": "t", "activation": "activation",
                "last_active": "last_active_iter", "last_covis": "last_covis_iter"}


class FusedCall(NamedTuple):
    """What a fused BA call does beyond its iterations (the graph's key
    holds it): the previous epoch's scheme-end tasks first (a drain that
    starts a new epoch), the epoch-ending ones last (a keyframe call), and
    the iteration's statics."""

    end_first: bool
    end_last: bool
    activate_all: bool
    optimize_geometry: bool
    do_surfel_updates: bool
    optimize_poses: bool


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
        # The host-known surfel bound and bucket state (module docstring):
        # the JAX package's known_surfel_bound with its epoch and pre-sized
        # epochs, the same bound without the pre-sizing, and the keyframe
        # bucket's high-water mark.
        self.known_surfel_bound = 0
        self._creation_bound = 0
        self._bound_epoch = -1
        self._prebudgeted_epochs = 0
        self._kf_bucket_floor = 0
        # Depth-deformation parameters (DepthParameters analog), identity
        # until self-calibration updates them.
        self.depth_params = empty_depth_params(
            cam.height, cam.width, self.config.sparse_surfel_cell_size,
            self.device)
        # Set when self-calibration changed `cam`; the front end refreshes
        # its cameras and clears it.
        self.intrinsics_updated = False
        # Diagnostics: iterations run by each BA call (alternating or PCG;
        # a graph replay's as a device scalar until read), the CG steps of
        # each PCG outer iteration, and the elapsed time of each intrinsics
        # step and each PCG outer iteration.
        self._iterations_run: List[Union[int, torch.Tensor]] = []
        self.cg_steps = []
        self.intrinsics_spans = Spans(self.device)
        self.pcg_spans = Spans(self.device)
        # Elapsed time of each bundle_adjustment call.
        self.ba_spans = Spans(self.device)
        # The text stream of the timing rows (set_save_timings).
        self.timings_stream = None

    def set_save_timings(self, stream) -> None:
        self.timings_stream = stream

    @property
    def iterations_run(self) -> List[int]:
        """The iterations of each BA call so far (a device read of the
        graph replays' counts not read yet)."""
        runs = self._iterations_run
        pending = [i for i, n in enumerate(runs) if isinstance(n, torch.Tensor)]
        if pending:
            values = torch.stack([runs[i] for i in pending]).tolist()
            for i, v in zip(pending, values):
                runs[i] = int(v)
        return runs

    def _synchronize(self) -> None:
        """Wait for the BA work queued on this device and the mesh's."""
        devices = [self.device] + (self.mesh.distinct() if self.mesh is not None else [])
        for d in dict.fromkeys(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    @contextlib.contextmanager
    def _stage(self, name: Optional[str], span: Optional[str], stamp: Optional[str] = None):
        """One BA stage: its profiler range `span` (None: none) and, under
        sync_stage_profiling, its timer `name` (the JAX package's; None:
        untimed), ended by a device synchronization (of every device of the
        mesh), and its timing row. Inside a CUDA-graph capture no range: the
        stage's device time is stamped as "<stamp or name> [graph]". Else
        untimed."""
        if capturing():
            with stamped(stamp or name, self.device):
                yield
            return
        with trace_range(span):
            if name is None or not self.config.sync_stage_profiling:
                yield
                return
            with Timing.time(name, sync=self.device) as timed_span:
                yield
                self._synchronize()
        if self.timings_stream is not None:
            self.timings_stream.write(f"{name.replace(' ', '_')} {timed_span.ms:.3f}\n")

    def _count_rows(self, smap) -> None:
        """Inside a capture: the rows of the surfel bucket that a pass runs
        over and the valid surfels among them, as the counters "BA surfel
        rows" and "BA live surfels"."""
        if not (Timing.stamping and capturing()):
            return
        maps = smap.shards if isinstance(smap, parallel.ShardedMap) else (smap,)
        count("BA surfel rows", sum(m.valid.numel() for m in maps), self.device)
        count("BA live surfels", sum(m.valid.sum().to(self.device) for m in maps),
              self.device)

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
        `new_keyframes` keyframes can create (one surfel per cell each): a
        read of the count, for the host paths (PCG, intrinsics, export)."""
        size = self.surfel_count + new_keyframes * self._cells_per_keyframe()
        return sf.prefix(self.surfels, min(size, self.surfels.capacity))

    # ------------------------------------------------------------------
    # Buckets (host arithmetic, the JAX package's)
    # ------------------------------------------------------------------

    def _bucket_size(self, needed: int) -> int:
        """The pow-2 surfel bucket from surfel_bucket_base that holds
        `needed` rows, at most the capacity."""
        cap = self.surfels.capacity
        b = max(1, self.config.surfel_bucket_base)
        while b < needed and b < cap:
            b *= 2
        return min(b, cap)

    def surfel_bucket(self) -> int:
        """The rows of the map a BA call works on (module docstring)."""
        return self._bucket_size(max(self.known_surfel_bound, self._creation_bound))

    def _grow_surfel_bound(self) -> None:
        """Once per BA epoch: count * cells more surfels may be created."""
        if self._bound_epoch != self.ba_iteration_count:
            growth = self.keyframes.count * self._cells_per_keyframe()
            if self.ba_iteration_count >= self._prebudgeted_epochs:
                self.known_surfel_bound += growth
            self._creation_bound += growth
            self._bound_epoch = self.ba_iteration_count

    def prebudget_epochs(self, expected_keyframes: int) -> None:
        """Pre-size the surfel bound for a run with a known keyframe budget:
        it covers the first `expected_keyframes` BA epochs, which then do
        not grow it (the JAX package's prebudget_epochs)."""
        e = max(0, int(expected_keyframes))
        self.known_surfel_bound = max(
            self.known_surfel_bound,
            min(self._cells_per_keyframe() * (e * (e + 1)) // 2, self.surfels.capacity))
        self._prebudgeted_epochs = e

    def _keyframe_bucket(self) -> Optional[List[int]]:
        """The slots of the keyframe bucket, live slots first and padded with
        distinct dead slots, or None for the whole capacity (the JAX
        package's _keyframe_bucket, from host metadata only): the pow-2
        bucket from keyframe_bucket_base that holds the live keyframes,
        never below its high-water mark, and only while it is at most half
        the capacity."""
        ks = self.keyframes
        cap = ks.capacity
        live = ks.live_count
        if live == 0:
            return None
        b = max(1, self.config.keyframe_bucket_base, self._kf_bucket_floor)
        while b < live:
            b *= 2
        if b > cap // 2:
            return None
        self._kf_bucket_floor = b
        free = ks.free_slot_set
        live_slots = [s for s in range(ks.count) if s not in free]
        pad = [s for s in range(cap) if s >= ks.count or s in free][: b - len(live_slots)]
        return live_slots + pad

    # ------------------------------------------------------------------
    # Surfel lifecycle
    # ------------------------------------------------------------------

    def create_surfels_for_keyframe(self, kf_id: int,
                                    filter_new_surfels: bool = True) -> torch.Tensor:
        """Create surfels for one keyframe slot (the first keyframe's
        bootstrap) on the whole map, as the JAX package. Returns the number
        created as a device scalar."""
        ks = self.keyframes
        self.known_surfel_bound += self._cells_per_keyframe()
        self._creation_bound += self._cells_per_keyframe()
        mask = torch.zeros(ks.count, dtype=torch.bool, device=self.device)
        mask[kf_id] = True
        slots = self._store_slots(ks.count)
        view, created = sf.create_surfels_for_keyframes(
            self.surfels, self.cam, slots.stack(slots.q, slots.t, slots.valid), mask,
            slots.covis, self.min_observation_count(),
            baseline_fx=self.config.baseline_fx,
            cell_size=self.config.sparse_surfel_cell_size,
            filter_new_surfels=filter_new_surfels, rgb_stack=slots.rgb)
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
    # Keyframe state of a call
    # ------------------------------------------------------------------

    def _store_slots(self, n: int) -> Slots:
        """Views of the store's slots [0, n)."""
        ks = self.keyframes
        return Slots(ks.depth[:n], ks.nx[:n], ks.ny[:n], ks.radius2[:n],
                     ks.intensity[:n], ks.rgb[:n], ks.q[:n], ks.t[:n], ks.valid[:n],
                     ks.activation[:n], ks.last_active_iter[:n], ks.last_covis_iter[:n],
                     ks.covis[:n, :n])

    def _gathered_slots(self, sel: Optional[torch.Tensor]) -> Slots:
        """The keyframe bucket: the store's slots `sel` (an index tensor)
        gathered, or views of the whole capacity for None."""
        if sel is None:
            return self._store_slots(self.keyframes.capacity)
        full = self._store_slots(self.keyframes.capacity)
        return Slots(*(x.index_select(0, sel) for x in full[:-2]),
                     full.covis.index_select(0, sel).index_select(1, sel), sel)

    def _store_state(self, slots: Slots, state, sel: Optional[torch.Tensor]) -> None:
        """Write a call's keyframe state (poses, activation, counters) back
        into the store, in place: into the views, or scattered to `sel`."""
        ks = self.keyframes
        for name, value in zip(_SLOT_STATE, state):
            if sel is None:
                view = getattr(slots, name)
                if value is not view:
                    view.copy_(value)
            else:
                getattr(ks, _STORE_FIELD[name]).index_copy_(0, sel, value)

    # ------------------------------------------------------------------
    # Stages: one device, or the mesh when the map is a ShardedMap
    # ------------------------------------------------------------------

    def _create_surfels(self, smap, slots: Slots, stack: KeyframeStack, mask,
                        min_obs, control: Control):
        c = self.config
        if isinstance(smap, parallel.ShardedMap):
            return parallel.create_surfels_streamed(
                self.mesh, smap, self.cam, self._planes, stack.q, stack.t, mask,
                slots.covis, slots.valid, min_obs, baseline_fx=c.baseline_fx,
                cell_size=c.sparse_surfel_cell_size, slots=slots.ids, control=control)
        return sf.create_surfels_for_keyframes(
            smap, self.cam, stack, mask, slots.covis, min_obs,
            baseline_fx=c.baseline_fx, cell_size=c.sparse_surfel_cell_size,
            rgb_stack=slots.rgb, loop=control)

    def _merge_surfels(self, smap, slots: Slots, stack: KeyframeStack, mask,
                       control: Control):
        c = self.config
        if isinstance(smap, parallel.ShardedMap):
            return parallel.merge_surfels_streamed(
                self.mesh, smap, self.cam, self._planes, stack.q, stack.t, mask,
                baseline_fx=c.baseline_fx, cell_size=c.sparse_surfel_cell_size,
                merge_dist_factor=c.surfel_merge_dist_factor, slots=slots.ids,
                control=control)
        return sf.merge_surfels_for_keyframes(
            smap, self.cam, stack, mask, baseline_fx=c.baseline_fx,
            cell_size=c.sparse_surfel_cell_size,
            merge_dist_factor=c.surfel_merge_dist_factor, loop=control)

    def _compact(self, smap):
        if isinstance(smap, parallel.ShardedMap):
            return parallel.compact_surfels_streamed(self.mesh, smap)
        return sf.compact_surfels(smap)

    def _delete_surfels(self, smap, slots: Slots, stack: KeyframeStack, min_obs):
        c = self.config
        if isinstance(smap, parallel.ShardedMap):
            return parallel.delete_surfels_streamed(
                self.mesh, smap, self.cam, self._planes, stack.q, stack.t,
                stack.mask, min_obs, baseline_fx=c.baseline_fx, slots=slots.ids)
        return sf.delete_surfels_and_update_radii(
            smap, self.cam, stack, min_obs, baseline_fx=c.baseline_fx)

    def _geometry(self, smap, slots: Slots, stack: KeyframeStack, active_strict,
                  participating, optimize_geometry):
        """Surfel activation and normals, then (with optimize_geometry) the
        positions and descriptors over the participating keyframes. With
        optimize_geometry activation and normals are one pass, timed with
        the positions as geometry optimization, beside an empty activation
        stage (the module docstring)."""
        c = self.config
        if optimize_geometry and c.sync_stage_profiling:
            with self._stage("BA surfel activation", None):
                pass  # fused into the geometry stage's pass
        self._count_rows(smap)
        with self._stage("BA geometry optimization" if optimize_geometry
                         else "BA surfel activation", None, "BA geometry optimization"):
            if isinstance(smap, parallel.ShardedMap):
                with trace_range("ba/activation_geometry"):
                    return parallel.activation_geometry_streamed(
                        self.mesh, smap, self.cam, self._planes, stack.q, stack.t,
                        active_strict, participating, baseline_fx=c.baseline_fx,
                        use_depth=c.use_geometric_residuals,
                        use_descriptor=c.use_photometric_residuals,
                        optimize_geometry=optimize_geometry, slots=slots.ids)
            with trace_range("ba/activation_normals"):
                smap = update_activation_and_normals(
                    smap, self.cam, stack, active_strict, participating,
                    baseline_fx=c.baseline_fx, update_normals=optimize_geometry)
            if optimize_geometry:
                with trace_range("ba/position"):
                    smap = _position_step(
                        smap, self.cam, stack._replace(mask=participating),
                        baseline_fx=c.baseline_fx,
                        use_depth=c.use_geometric_residuals,
                        use_descriptor=c.use_photometric_residuals)
        return smap

    def _poses(self, smap, slots: Slots, stack: KeyframeStack, control: Control):
        c = self.config
        if isinstance(smap, parallel.ShardedMap):
            return parallel.optimize_poses_streamed(
                self.mesh, smap, self.cam, self._planes, stack.q, stack.t,
                stack.mask, baseline_fx=c.baseline_fx,
                use_depth=c.use_geometric_residuals,
                use_descriptor=c.use_photometric_residuals, max_iterations=30,
                slots=slots.ids, control=control)
        return optimize_keyframe_poses(
            smap, self.cam, stack, baseline_fx=c.baseline_fx,
            use_depth=c.use_geometric_residuals,
            use_descriptor=c.use_photometric_residuals, max_iterations=30,
            loop=control)

    def _scheme_end_core(self, smap, slots: Slots, q, t, last_active, ba_iter,
                         min_obs, do_surfel_updates: bool, control: Control = HOST):
        """PerformBASchemeEndTasks (direct_ba.cc:566-653): a final merge
        over this epoch's active keyframes, then delete and compact."""
        stack = slots.stack(q, t, slots.valid)
        with self._stage(None, "ba/scheme_end", "BA scheme end"):
            if do_surfel_updates:
                recently_active = slots.valid & (last_active == ba_iter)
                smap = self._merge_surfels(smap, slots, stack, recently_active, control)
            return self._compact(self._delete_surfels(smap, slots, stack, min_obs))

    def _prepare_mesh(self) -> None:
        """Before a call over the mesh (on the host, outside any graph):
        the plane layout and the planes brought up to date."""
        self._streaming = self._plane_streaming_wanted()
        self.mesh_planes(self._streaming)

    def _split(self, view):
        """The working view over the mesh (planes brought up to date), or
        the view itself without a mesh."""
        if self.mesh is None:
            return view
        self._prepare_mesh()
        return parallel.shard_rows(self.mesh, view)

    def _join(self, smap):
        if isinstance(smap, parallel.ShardedMap):
            return parallel.gather_rows(self.mesh, smap, self.device)
        return smap

    def perform_ba_scheme_end_tasks(self, do_surfel_updates: bool = True) -> None:
        if self.keyframes.count == 0:
            return
        slots = self._store_slots(self.keyframes.count)
        view = self._scheme_end_core(
            self._split(self._working_map(0)), slots, slots.q, slots.t,
            slots.last_active, self.ba_iteration_count, self.min_observation_count(),
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

    def _iteration_core(self, smap, slots: Slots, q, t, activation, last_active,
                        last_covis, ba_iter, min_obs, *, activate_all: bool,
                        optimize_geometry: bool, do_surfel_updates: bool,
                        optimize_poses: bool, control: Control = HOST):
        """One alternating-BA iteration (direct_ba_alternating.cc:345-626)
        as a function of the map and the keyframe state (the JAX package's
        _iteration_core): returns (map, q, t, activation, last_active,
        last_covis). Each stage runs in `_stage`, by its JAX timer name."""
        valid = slots.valid
        if activate_all:
            activation = torch.where(valid, ACTIVE, INACTIVE)
        newly_active = valid & (activation == ACTIVE) & (last_active != ba_iter)
        newly_covis = valid & (activation == COVISIBLE_ACTIVE) & (last_covis != ba_iter)
        last_active = torch.where(newly_active, ba_iter, last_active)
        last_covis = torch.where(newly_covis, ba_iter, last_covis)
        stack = slots.stack(q, t, valid)

        if optimize_geometry and do_surfel_updates:
            with self._stage("BA surfel creation", "ba/create", "BA surfel upkeep"):
                smap, _ = self._create_surfels(smap, slots, stack, newly_active,
                                               min_obs, control)

        active_strict = valid & (activation == ACTIVE)
        participating = valid & ((activation == ACTIVE)
                                 | (activation == COVISIBLE_ACTIVE))
        smap = self._geometry(smap, slots, stack, active_strict, participating,
                              optimize_geometry)
        if do_surfel_updates:
            with self._stage("BA surfel merge", "ba/merge", "BA surfel upkeep"):
                smap = self._merge_surfels(smap, slots, stack, newly_active, control)
            with self._stage("BA surfel compaction", "ba/compact", "BA surfel upkeep"):
                smap = self._compact(smap)

        if optimize_poses:
            self._count_rows(smap)
            with self._stage("BA pose optimization", "ba/poses"):
                result = self._poses(smap, slots, stack._replace(mask=participating),
                                     control)
                q = torch.where(participating[:, None], result.q, q)
                t = torch.where(participating[:, None], result.t, t)
                activation = torch.where(
                    participating, torch.where(result.moved, ACTIVE, INACTIVE),
                    activation)
        activation = kfs.propagate_covisible_active(slots.covis, activation, valid)
        return smap, q, t, activation, last_active, last_covis

    def _iteration(self, smap, activate_all: bool, optimize_geometry: bool,
                   do_surfel_updates: bool, optimize_poses: bool):
        """One iteration of the host loop on the store's slots [0, count),
        which it updates in place; returns the map."""
        slots = self._store_slots(self.keyframes.count)
        out = self._iteration_core(
            smap, slots, slots.q, slots.t, slots.activation, slots.last_active,
            slots.last_covis, self.ba_iteration_count, self.min_observation_count(),
            activate_all=activate_all, optimize_geometry=optimize_geometry,
            do_surfel_updates=do_surfel_updates, optimize_poses=optimize_poses)
        self._store_state(slots, out[1:], None)
        return out[0]

    def _fused_program(self, smap, sel: Optional[torch.Tensor], limit: torch.Tensor,
                       ba_iter: torch.Tensor, min_obs: torch.Tensor, call: FusedCall,
                       control: Control, most: Optional[int] = None):
        """The fused BA call on the working map `smap` (a prefix of the
        map's storage) and the keyframe bucket `sel` (module docstring):
        fewer than `limit` iterations (and at most `most`, the host bound
        of the host and masked controls). Writes the keyframe state back
        into the store and the map into its storage, in place; returns the
        iterations run."""
        slots = self._gathered_slots(sel)
        valid = slots.valid
        state = tuple(getattr(slots, name) for name in _SLOT_STATE)
        if self.mesh is not None:
            smap = parallel.shard_rows(self.mesh, smap)
        if call.end_first:
            smap = self._scheme_end_core(smap, slots, slots.q, slots.t, slots.last_active,
                                         ba_iter, min_obs, call.do_surfel_updates,
                                         control)
        # Reset the surfel active flags for this BA block
        # (direct_ba_alternating.cc:338).
        smap = _without_active(smap)
        if call.activate_all:
            # The loop's test runs before the first iteration; with the
            # activate-all window every valid keyframe enters it active.
            state = (state[0], state[1], torch.where(valid, ACTIVE, INACTIVE), *state[3:])
        # The loop's state: the map's tensors (every shard's over a mesh),
        # then the keyframe state.
        flat = _flat(smap)
        n = len(flat)

        def any_active(st):
            return (valid & (st[n + 2] == ACTIVE)).any()

        def step(st):
            with self._stage(None, None, "BA iteration"):
                out = self._iteration_core(
                    _unflat(smap, st[:n]), slots, *st[n:], ba_iter, min_obs,
                    activate_all=call.activate_all,
                    optimize_geometry=call.optimize_geometry,
                    do_surfel_updates=call.do_surfel_updates,
                    optimize_poses=call.optimize_poses, control=control)
            return (*_flat(out[0]), *out[1:])

        st, iterations = loop(control, (*flat, *state), any_active, step, most=most,
                              limit=limit, name="iterations")
        smap, state = _unflat(smap, st[:n]), st[n:]
        if call.end_last:
            smap = self._scheme_end_core(smap, slots, state[0], state[1], state[3],
                                         ba_iter, min_obs, call.do_surfel_updates,
                                         control)
        self._store_state(slots, state, sel)
        sf.write_back(self.surfels, self._join(smap))
        return iterations

    def _fused_inputs(self, sel: Optional[List[int]], max_iterations: int):
        """The device inputs of a fused call made eagerly: the keyframe
        bucket's slots, the iteration limit, the epoch and the observation
        filter's count (host values uploaded; nothing is read)."""
        def scalar(v):
            return torch.tensor(v, dtype=torch.int64, device=self.device)

        return (None if sel is None else torch.tensor(sel, dtype=torch.int64,
                                                      device=self.device),
                scalar(max_iterations), scalar(self.ba_iteration_count),
                scalar(self.min_observation_count()))

    def bundle_adjustment(self, optimize_poses: bool = True,
                          optimize_geometry: bool = True,
                          do_surfel_updates: bool = True,
                          max_iterations: int = 10,
                          increase_ba_iteration_count: bool = True,
                          activate_all: Optional[bool] = None,
                          optimize_depth_intrinsics: bool = False,
                          optimize_color_intrinsics: bool = False,
                          active_keyframe_window=None, loop: Control = HOST,
                          graph=None):
        """Run up to `max_iterations` iterations of the alternating scheme,
        stopping early when no keyframe is ACTIVE. Returns the number of
        iterations run: an int from the host loops, else an int64 scalar
        tensor (a graph replay's on the card; ``iterations_run`` reads it
        when that list is read).

        A call the JAX package runs as its fused program (module docstring)
        is the fused call: with `graph` (a ``ba.graph.BAGraph`` on a CUDA
        device) one replay of its captured graph, else eagerly under the
        loop control `loop` (HOST, or MASKED, which reads nothing).

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
                active_keyframe_window, loop, graph)
        self._iterations_run.append(iterations)
        return iterations

    def _bundle_adjustment(self, optimize_poses, optimize_geometry,
                           do_surfel_updates, max_iterations,
                           increase_ba_iteration_count, activate_all,
                           optimize_depth_intrinsics, optimize_color_intrinsics,
                           active_keyframe_window, control, graph):
        c = self.config
        fixed_window = active_keyframe_window is not None
        intrinsics = optimize_depth_intrinsics or optimize_color_intrinsics
        self._grow_surfel_bound()
        end_first = (not increase_ba_iteration_count
                     and self.ba_iteration_count != self.last_ba_iteration_count)
        if end_first:
            self.last_ba_iteration_count = self.ba_iteration_count
        if not (fixed_window or intrinsics or c.sync_stage_profiling):
            iterations = self._fused_bundle_adjustment(
                max_iterations, FusedCall(end_first, increase_ba_iteration_count,
                                          activate_all, optimize_geometry,
                                          do_surfel_updates, optimize_poses),
                control, graph)
        else:
            iterations = self._host_loop(
                optimize_poses, optimize_geometry, do_surfel_updates, max_iterations,
                increase_ba_iteration_count, activate_all, optimize_depth_intrinsics,
                optimize_color_intrinsics, active_keyframe_window, end_first)
        if increase_ba_iteration_count:
            self.ba_iteration_count += 1
            if c.sync_surfel_bucket:
                # One read per epoch-ending call ("surfels_size_" resync),
                # after the scheme-end compaction: the valid surfels are then
                # packed into [0, count), so the bound may shrink safely.
                self.known_surfel_bound = self._creation_bound = self.surfel_count + 64
        return iterations

    def _fused_bundle_adjustment(self, max_iterations: int, call: FusedCall,
                                 control: Control, graph) -> Union[int, torch.Tensor]:
        """The fused call (module docstring), timed as the JAX package's
        fused program (its streamed program over a mesh that streams the
        planes), with its timing row (none for the streamed program)."""
        if self.mesh is not None:
            self._prepare_mesh()
        sel = None if self._streaming else self._keyframe_bucket()
        bucket = self.surfel_bucket()
        timer = "BA iterations (streamed)" if self._streaming else "BA iterations (fused)"
        with _timer(timer, self.device):
            if graph is not None:
                iterations = graph.run(self, sel, bucket, max_iterations, call)
            else:
                sel_t, limit, ba_iter, min_obs = self._fused_inputs(sel, max_iterations)
                iterations = self._fused_program(
                    sf.prefix(self.surfels, bucket), sel_t, limit, ba_iter, min_obs,
                    call, control, most=max_iterations)
        if not self._streaming:
            self._fused_row(max_iterations)
        return iterations

    def _fused_row(self, max_iterations: int) -> None:
        """The timing row of a call the JAX package runs as its fused
        program, with the host's wait in a synchronization at its end."""
        if self.timings_stream is None:
            return
        t0 = time.perf_counter()
        self._synchronize()
        self.timings_stream.write(
            f"BA_count {self.ba_iteration_count} fused_iterations {max_iterations} "
            f"keyframe_count {self.keyframes.live_count} surfel_bound "
            f"{self.known_surfel_bound} sync_ms {1e3 * (time.perf_counter() - t0):.3f}\n")

    def _host_loop(self, optimize_poses, optimize_geometry, do_surfel_updates,
                   max_iterations, increase_ba_iteration_count, activate_all,
                   optimize_depth_intrinsics, optimize_color_intrinsics,
                   active_keyframe_window, end_first) -> int:
        """The JAX package's host loop (fixed window, self-calibration,
        staged profiling) on the store's slots [0, count), one iteration per
        host step; staged profiling runs its stages over the mesh, if any."""
        c = self.config
        ks = self.keyframes
        k = ks.count
        fixed_window = active_keyframe_window is not None
        intrinsics = optimize_depth_intrinsics or optimize_color_intrinsics
        host_loop = fixed_window or intrinsics
        smap = sf.prefix(self.surfels, self.surfel_bucket())
        if not host_loop:
            smap = self._split(smap)

        if end_first:
            slots = self._store_slots(k)
            smap = self._scheme_end_core(smap, slots, slots.q, slots.t, slots.last_active,
                                         self.ba_iteration_count,
                                         self.min_observation_count(), do_surfel_updates)

        # Reset the surfel active flags for this BA block
        # (direct_ba_alternating.cc:338).
        smap = _without_active(smap)
        # Staged profiling is one of the JAX package's host-loop modes too:
        # every iteration runs there, with the stages timed one by one.
        iteration_timer = "BA iteration" if host_loop and not c.sync_stage_profiling else None
        for iterations in range(max_iterations):
            if fixed_window:
                ks.set_activation_window(*active_keyframe_window)
                ks.propagate_covisible_active()
            if c.sync_stage_profiling and self.timings_stream is not None:
                self.timings_stream.write(
                    f"BA_count {self.ba_iteration_count} inner_iteration "
                    f"{iterations} keyframe_count {ks.live_count} "
                    f"surfel_bound {self.known_surfel_bound}\n")
            with _timer(iteration_timer, self.device):
                smap = self._iteration(smap, activate_all, optimize_geometry,
                                       do_surfel_updates, optimize_poses)
            if intrinsics:
                with Timing.time("BA intrinsics optimization",
                                 sync=self.device if c.sync_stage_profiling else None,
                                 device=self.device):
                    self._intrinsics_step(
                        smap, optimize_depth_intrinsics and c.use_geometric_residuals,
                        optimize_color_intrinsics and c.use_photometric_residuals)

        if increase_ba_iteration_count:
            slots = self._store_slots(k)
            smap = self._scheme_end_core(smap, slots, slots.q, slots.t, slots.last_active,
                                         self.ba_iteration_count,
                                         self.min_observation_count(), do_surfel_updates)
        self.surfels = sf.write_back(self.surfels, self._join(smap))
        return max_iterations

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
