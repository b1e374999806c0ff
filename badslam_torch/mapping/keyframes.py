"""Keyframe storage: stacked device planes plus device metadata.

Counterpart of ``badslam_tpu/mapping/keyframes.py`` (the reference's
per-keyframe buffers, keyframe.h:50-237). All keyframe planes live in
stacked [K, H, W] tensors whose capacity doubles when it runs out; slots
freed by keyframe merging are reused before new ones are opened. Validity,
activation, covisibility, min/max depth and the BA bookkeeping counters are
device tensors. The host keeps the slot count, the free slots and each
slot's dataset frame index.

Every field that a BA call reads or writes is updated in place (slot
writes, ``copy_``), so a captured CUDA graph of a BA call
(``ba/graph.py``) keeps reading the store's storage; only a growth of the
capacity (``_grow``, ``_ensure_capacity``) reallocates it, and it bumps
``generation``, which the graph's key holds: a grown store is captured
anew. A front end with a known dataset length sizes the store up front
(``_ensure_capacity``), as the JAX package does.

Passes over several keyframes inside a BA call take ``static_blocks``:
fixed blocks of ``KEYFRAME_BATCH`` slots with the operation's mask carried
along (the JAX package's fixed chunks, which need no host read), where the
host paths (PCG, intrinsics) take ``keyframe_batches`` of the set slots.

Activation states mirror Keyframe::Activation (keyframe.h:54-67):
INACTIVE=0, COVISIBLE_ACTIVE=1, ACTIVE=2.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch

from badslam_torch.geometry import se3
from badslam_torch.mapping import frustum
from badslam_torch.ops.preprocess import ProcessedFrame

INACTIVE = 0
COVISIBLE_ACTIVE = 1
ACTIVE = 2

# Initial slot capacity (the JAX package's keyframe_bucket_base default).
_INITIAL_CAPACITY = 8
# Keyframes per batched pass over the map (the JAX package's _KF_BATCH):
# bounds the [C, N] intermediates.
KEYFRAME_BATCH = 8


def static_blocks(n: int) -> List[slice]:
    """The slots [0, n) in fixed blocks of up to KEYFRAME_BATCH."""
    return [slice(i, min(i + KEYFRAME_BATCH, n)) for i in range(0, n, KEYFRAME_BATCH)]


def keyframe_batches(mask: torch.Tensor) -> list:
    """The set slots of a [K] bool keyframe mask (one device read), in
    batches of up to KEYFRAME_BATCH, each as a slice where the slots are
    consecutive (a view of the stacked planes) or else as an index tensor."""
    ids = torch.nonzero(mask).flatten().tolist()
    out = []
    for i in range(0, len(ids), KEYFRAME_BATCH):
        b = ids[i:i + KEYFRAME_BATCH]
        out.append(slice(b[0], b[-1] + 1) if b[-1] - b[0] == len(b) - 1
                   else torch.tensor(b, device=mask.device))
    return out


class KeyframeStack(NamedTuple):
    """The slice of keyframe state that BA passes read (a plane a pass does
    not read may be None)."""

    depth: torch.Tensor      # [K, H, W] f32, 0 invalid
    nx: torch.Tensor         # [K, H, W]
    ny: torch.Tensor         # [K, H, W]
    radius2: torch.Tensor    # [K, H, W]
    intensity: torch.Tensor  # [K, H, W]
    q: torch.Tensor          # [K, 4] global_T_frame rotation (wxyz)
    t: torch.Tensor          # [K, 3] global_T_frame translation
    mask: torch.Tensor       # [K] bool: takes part in the current operation

    def rows(self, s) -> "KeyframeStack":
        """The keyframes at `s` (a slice or an index tensor)."""
        return KeyframeStack(*(None if x is None else x[s] for x in self))


def covisibility_row(cam, q, t, min_d, max_d, valid, new_id: int) -> torch.Tensor:
    """[K] bool: valid keyframes whose frustum intersects keyframe new_id's
    (DetermineNewKeyframeCoVisibility, direct_ba.cc:231-249)."""
    pts = frustum.frustum_points(cam, q, t, min_d, max_d)
    row = frustum.intersects(pts[new_id][None], pts)
    ids = torch.arange(q.shape[0], device=q.device)
    return row & valid & (ids != new_id)


def register_covisibility(covis, activation, row, new_id: int) -> None:
    """Symmetric covisibility update and promotion of INACTIVE covisible
    keyframes to COVISIBLE_ACTIVE (direct_ba.cc:240-247), in place."""
    covis[new_id] = row
    covis[:, new_id] = row
    activation.copy_(torch.where(row & (activation == INACTIVE), COVISIBLE_ACTIVE,
                                 activation))


def active_mask(valid, activation, include_covisible: bool) -> torch.Tensor:
    m = valid & (activation == ACTIVE)
    if include_covisible:
        m = m | (valid & (activation == COVISIBLE_ACTIVE))
    return m


def propagate_covisible_active(covis, activation, valid) -> torch.Tensor:
    """DetermineCovisibleActiveKeyframes (direct_ba.cc:549-564)."""
    activation = torch.where(activation == COVISIBLE_ACTIVE, INACTIVE, activation)
    active = valid & (activation == ACTIVE)
    touched = (covis & active[None, :]).any(dim=1)
    return torch.where(valid & touched & (activation == INACTIVE),
                       COVISIBLE_ACTIVE, activation)


def redundancy_scores(q, t, valid, prev, nxt) -> torch.Tensor:
    """Per-keyframe merge score: distance plus angle to the temporally
    previous and next keyframes, 90 degrees counting as 0.5 m
    (MergeKeyframes, direct_ba.cc:251-338). `prev`/`nxt` are temporal
    neighbour slots (-1 at the trajectory ends, never merged). Ineligible
    keyframes score +inf."""
    cap = q.shape[0]
    idx = torch.arange(cap, device=q.device)
    z_axis = se3.quat_to_matrix(q)[:, :, 2]

    def half_dist(a, b_idx):
        b = torch.clamp(b_idx, 0, cap - 1)
        ang = torch.arccos(torch.clamp(
            torch.sum(z_axis[a] * z_axis[b], dim=-1), -1.0, 1.0))
        dist = torch.linalg.vector_norm(t[a] - t[b], dim=-1)
        ok = (ang <= 0.25 * math.pi * 2.0 * 0.5) & (dist <= 0.3)
        return torch.where(ok, dist + (0.5 / (math.pi / 2.0)) * ang, math.inf)

    score = half_dist(idx, prev) + half_dist(idx, nxt)
    eligible = valid & (prev >= 0) & (nxt >= 0)
    return torch.where(eligible, score, math.inf)


class KeyframeStore:
    """Stacked keyframe state on one device."""

    def __init__(self, cam, device: torch.device | str,
                 capacity: int = _INITIAL_CAPACITY):
        self.cam = cam
        self.device = torch.device(device)
        self.capacity = 0
        self.count = 0  # high-water slot count
        self.frame_indices: List[int] = []
        self.free_slots: List[int] = []
        # Slots whose planes were written since a multi-device BA last
        # copied them to its shards (ba/scheme.py); a reallocation by
        # _grow replaces every plane tensor and is seen there by itself.
        self.changed_slots: set = set()
        # Bumped by every reallocation of the per-slot tensors.
        self.generation = 0
        self._grow(max(1, capacity))

    # ------------------------------------------------------------------

    def _grow(self, new_cap: int) -> None:
        """Reallocate every per-slot tensor at `new_cap` slots, keeping the
        first `capacity` rows."""
        h, w = self.cam.height, self.cam.width
        dev = self.device
        old = self.capacity

        def grown(name, shape, dtype=torch.float32, fill=0):
            fresh = torch.full(shape, fill, dtype=dtype, device=dev)
            if old:
                fresh[:old] = getattr(self, name)
            return fresh

        for name in ("depth", "raw_depth", "nx", "ny", "radius2", "intensity"):
            setattr(self, name, grown(name, (new_cap, h, w)))
        self.rgb = grown("rgb", (new_cap, h, w, 3), torch.uint8)
        self.q = grown("q", (new_cap, 4))
        if not old:
            self.q[:, 0] = 1.0
        else:
            self.q[old:, 0] = 1.0
        self.t = grown("t", (new_cap, 3))
        self.valid = grown("valid", (new_cap,), torch.bool, False)
        self.activation = grown("activation", (new_cap,), torch.int64, INACTIVE)
        self.min_depth = grown("min_depth", (new_cap,))
        self.max_depth = grown("max_depth", (new_cap,))
        self.last_active_iter = grown("last_active_iter", (new_cap,), torch.int64, -1)
        self.last_covis_iter = grown("last_covis_iter", (new_cap,), torch.int64, -1)
        covis = torch.zeros((new_cap, new_cap), dtype=torch.bool, device=dev)
        if old:
            covis[:old, :old] = self.covis
        self.covis = covis
        self.capacity = new_cap
        self.generation += 1

    def _ensure_capacity(self, needed: int) -> None:
        """Grow to the first power-of-two multiple of the capacity that
        holds `needed` slots (the JAX package's _ensure_capacity)."""
        new_cap = max(self.capacity, 1)
        while new_cap < needed:
            new_cap *= 2
        if new_cap > self.capacity:
            self._grow(new_cap)

    @property
    def free_slot_set(self) -> set:
        return set(self.free_slots)

    @property
    def live_count(self) -> int:
        """Number of live (not freed) keyframes."""
        return self.count - len(self.free_slots)

    def live_slots_in_time_order(self) -> List[int]:
        """Live slot ids sorted by dataset frame index."""
        free = self.free_slot_set
        return [s for _, s in sorted(
            (f, s) for s, f in enumerate(self.frame_indices[: self.count])
            if f >= 0 and s not in free)]

    # ------------------------------------------------------------------

    def add_keyframe(self, frame: ProcessedFrame, global_T_frame: se3.SE3,
                     frame_index: int = -1) -> int:
        """Insert a keyframe (reusing a freed slot when there is one) and
        update covisibility; returns its slot id."""
        if self.free_slots:
            kf = self.free_slots.pop(0)
        else:
            kf = self.count
            self._ensure_capacity(kf + 1)
            self.count += 1
            self.frame_indices.append(-1)
        self.frame_indices[kf] = frame_index
        raw = frame.raw_depth if frame.raw_depth is not None else frame.depth
        if frame.rgb is not None:
            rgb = frame.rgb
        else:
            # Gray: the intensity plane in all three channels.
            g = torch.clamp(frame.intensity * 255.0 + 0.5, 0, 255)
            rgb = torch.stack([g, g, g], dim=-1).to(torch.uint8)
        self.depth[kf] = frame.depth
        self.raw_depth[kf] = raw
        self.nx[kf] = frame.nx
        self.ny[kf] = frame.ny
        self.radius2[kf] = frame.radius2
        self.intensity[kf] = frame.intensity
        self.rgb[kf] = rgb
        self.q[kf] = torch.as_tensor(global_T_frame.q, dtype=torch.float32,
                                     device=self.device)
        self.t[kf] = torch.as_tensor(global_T_frame.t, dtype=torch.float32,
                                     device=self.device)
        v = frame.depth > 0
        self.min_depth[kf] = torch.where(v, frame.depth, math.inf).min()
        self.max_depth[kf] = torch.where(v, frame.depth, 0.0).max()
        self.valid[kf] = True
        self.changed_slots.add(kf)
        self.activation[kf] = ACTIVE
        self.last_active_iter[kf] = -1
        self.last_covis_iter[kf] = -1
        row = covisibility_row(self.cam, self.q, self.t, self.min_depth,
                               self.max_depth, self.valid, kf)
        register_covisibility(self.covis, self.activation, row, kf)
        return kf

    def remove_keyframe(self, kf: int) -> None:
        """Delete a keyframe and put its slot on the free list."""
        self.valid[kf] = False
        self.activation[kf] = INACTIVE
        self.covis[kf] = False
        self.covis[:, kf] = False
        if kf < len(self.frame_indices):
            self.frame_indices[kf] = -1
        if kf not in self.free_slots:
            self.free_slots.append(kf)

    # ------------------------------------------------------------------

    def set_pose(self, kf: int, pose: se3.SE3) -> None:
        self.q[kf] = torch.as_tensor(pose.q, dtype=torch.float32, device=self.device)
        self.t[kf] = torch.as_tensor(pose.t, dtype=torch.float32, device=self.device)

    def pose(self, kf: int) -> se3.SE3:
        """A copy of the pose (BA updates the store in place)."""
        return se3.SE3(self.q[kf].clone(), self.t[kf].clone())

    def mask_for_ids(self, ids) -> torch.Tensor:
        """[capacity] bool mask of host-known keyframe ids."""
        m = torch.zeros(self.capacity, dtype=torch.bool)
        m[list(ids)] = True
        return m.to(self.device)

    def stack(self, mask: Optional[torch.Tensor] = None) -> KeyframeStack:
        """View of the slots [0, count); `mask` (a [capacity] or [count]
        bool tensor, or a list of ids) defaults to the valid mask."""
        k = self.count
        if isinstance(mask, (list, tuple, range)):
            mask = self.mask_for_ids(mask)
        mask = self.valid if mask is None else mask
        return KeyframeStack(self.depth[:k], self.nx[:k], self.ny[:k],
                             self.radius2[:k], self.intensity[:k],
                             self.q[:k], self.t[:k], mask[:k])

    def stack_raw(self) -> torch.Tensor:
        """The raw (pre-deformation) depth of the slots [0, count)."""
        return self.raw_depth[: self.count]

    def set_poses(self, q: torch.Tensor, t: torch.Tensor, mask: torch.Tensor) -> None:
        """Masked pose update of the slots [0, count) from rows [0, count)
        of q, t and mask."""
        k = self.count
        m = mask[:k, None]
        self.q[:k] = torch.where(m, q[:k], self.q[:k])
        self.t[:k] = torch.where(m, t[:k], self.t[:k])

    def recalibrate(self, cam, a, cfactor, cell_size: int) -> None:
        """Re-derive the calibrated depth, normals, radii and depth range of
        every valid keyframe from its raw depth after a self-calibration
        update (the JAX package's KeyframeStore.recalibrate)."""
        from badslam_torch.ba.intrinsics_opt import recalibrate_planes

        ids = torch.nonzero(self.valid[: self.count]).flatten()
        if ids.numel() == 0:
            return
        depth, nx, ny, radius2 = recalibrate_planes(
            cam, self.raw_depth[ids], a, cfactor, cell_size)
        self.changed_slots.update(ids.tolist())
        self.depth[ids] = depth
        self.nx[ids] = nx
        self.ny[ids] = ny
        self.radius2[ids] = radius2
        v = depth > 0
        self.min_depth[ids] = torch.where(v, depth, math.inf).amin(dim=(1, 2))
        self.max_depth[ids] = torch.where(v, depth, 0.0).amax(dim=(1, 2))

    def active_mask(self, include_covisible: bool = True) -> torch.Tensor:
        return active_mask(self.valid, self.activation, include_covisible)

    def propagate_covisible_active(self) -> None:
        self.activation.copy_(propagate_covisible_active(
            self.covis, self.activation, self.valid))

    def set_activation_window(self, lo: int, hi: int) -> None:
        """Activate the valid slots lo..hi and deactivate all others (the
        final BA's fixed window, main.cc:765-789)."""
        ids = torch.arange(self.capacity, device=self.device)
        window = self.valid & (ids >= lo) & (ids <= hi)
        self.activation.copy_(torch.where(window, ACTIVE, INACTIVE))

    def merge_redundant_keyframes(self, approx_merge_count: int) -> List[int]:
        """Free the most redundant keyframes (the memory-pressure path,
        MergeKeyframes analog). Scores on the device, one read of the
        chosen slots; returns the freed slot ids."""
        order = self.live_slots_in_time_order()
        k = min(approx_merge_count, max(0, len(order) - 2))
        if k == 0:
            return []
        prev = [-1] * self.capacity
        nxt = [-1] * self.capacity
        for i, s in enumerate(order):
            if i > 0:
                prev[s] = order[i - 1]
            if i + 1 < len(order):
                nxt[s] = order[i + 1]
        scores = redundancy_scores(
            self.q, self.t, self.valid,
            torch.tensor(prev, device=self.device),
            torch.tensor(nxt, device=self.device))
        # Lowest scores first; ties to the lower slot (lax.top_k's order).
        sel = torch.sort(scores, stable=True).indices[:k]
        finite = torch.isfinite(scores[sel])
        freed = [int(s) for s, f in zip(sel.tolist(), finite.tolist()) if f]
        for s in freed:
            self.remove_keyframe(s)
        return freed
