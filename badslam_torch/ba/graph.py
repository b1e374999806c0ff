"""The fused BA call as one CUDA graph per call, with its convergence exit
on the card.

Counterpart of the JAX package's fused BA programs (``badslam_tpu/ba/
scheme.py`` ``_ba_iterations`` and ``_ba_iterations_bucketed`` with
``_scheme_end_tasks``): every BA call that the JAX package runs as one
program is here one replay of a captured CUDA graph of
``DirectBA._fused_program``. One replay holds the previous epoch's
scheme-end tasks when a drain starts a new epoch, the reset of the surfel
active flags, the iterations and, on a keyframe call, the epoch-ending
scheme-end tasks. Its loops are WHILE nodes (``ops.conditional``): the
iterations (one node whose body is one iteration and ends by writing
"fewer than max_iterations and any keyframe ACTIVE"), and nested in that
body the creation and merge passes (one node each, whose body takes the
next set slot of the call's mask) and each keyframe block's Gauss-Newton
loop (one node per block of ``KEYFRAME_BATCH`` slots); the scheme-end
merge is one more node. So a replay decides every exit on the card and
reads nothing back.

The graph's static inputs are device scalars filled before each replay:
the iteration limit (``max_iterations``), the epoch
(``ba_iteration_count``) and the observation filter's count, and the
keyframe bucket's slot list (uploaded through pinned memory when it
changes), so one graph serves every drain length. The map's and the
store's tensors are read and written in place: their storage is part of
the key (``DirectBA.surfels``' data pointers and the store's
``generation``), so a grown store or a replaced map is captured anew.
The key also holds the call's kind (``FusedCall``: keyframe call or drain,
and whether the epoch changed, with the iteration's flags), the keyframe
bucket, the surfel bucket, the residual flags and constants of the config,
and the camera (its intrinsics are host floats baked into the graph). A
capture whose buckets or storage differ from a held graph's frees that
graph and its pools, so they do not pile up over a long run.

A call over a device mesh (``DirectBA.mesh``, every shard on this graph's
card) is captured the same way: the program splits its surfel bucket over
the shards and runs the stages of ``parallel/streamed.py``, whose creation
and merge are WHILE nodes over the call's mask and whose pose optimization
is one WHILE node per block of each shard's rows. The key then also holds
the mesh's devices, whether the planes stream (streamed planes take the
whole keyframe capacity, replicated ones the bucket) and the data pointers
of the planes' blocks, so a rebuilt ``Planes`` is captured anew and frees
the outgrown graph. ``DirectBA`` refreshes the planes on the host before
the replay; with every shard on one card the blocks are views of the
store, so nothing is copied. A mesh over several cards is not captured
(``run`` raises): the front end runs such a call eagerly.

Captured and replayed as ``ops.conditional.GraphOwner`` does it (a
capture failure raises; ``BadSlam.ba_graph = None`` asks for the eager
call), with the launches' shard tags (``kernels.launch_tags``) recorded at
the capture. Each replay's iteration count is copied on the card and read
with ``DirectBA.iterations_run`` (a report). A record of ``captures`` also
holds its key's kind and buckets and why it was captured
(``capture_reason``).

Timers (``utils.timing``): each replay is stamped on the card from its
first node to its last ("BA call [graph]", with a ring entry), each WHILE
node ("BA call: <body> [graph]"), each iteration's body ("BA iteration
[graph]"), its stages ("BA pose optimization", "BA geometry optimization",
"BA surfel upkeep", "BA scheme end", each "[graph]") and, per pass over
the surfel bucket, its rows and live surfels ("BA surfel rows [graph]",
"BA live surfels [graph]", counters). The capture is the profiler range
"capture/ba_graph"; inside it the stages open no range.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from badslam_torch.ba.scheme import DirectBA, FusedCall
from badslam_torch.mapping import surfels as sf
from badslam_torch.mapping.keyframes import KEYFRAME_BATCH
from badslam_torch.ops.conditional import GraphOwner


def _bodies(keyframes: int, shards: int) -> int:
    """The WHILE bodies a capture can make: the iterations, creation, merge,
    two scheme-end merges and one Gauss-Newton loop per keyframe block of
    each shard's rows (a counter is made per body before the capture)."""
    per_shard = -(-keyframes // shards)
    return 5 + shards * -(-per_shard // KEYFRAME_BATCH)



class BAKey(NamedTuple):
    call: FusedCall
    keyframe_bucket: int
    whole_capacity: bool
    surfel_bucket: int
    use_depth: bool
    use_descriptor: bool
    baseline_fx: float
    cell_size: int
    merge_dist_factor: float
    cam: object
    storage: tuple  # the store's generation, the map's and the planes' data pointers
    mesh: tuple     # over a mesh: its devices and whether the planes stream; else ()


# The parts of a BAKey that a capture's reason names, by their fields.
_KEY_PARTS = (("call kind", ("call",)),
              ("keyframe bucket", ("keyframe_bucket", "whole_capacity")),
              ("surfel bucket", ("surfel_bucket",)),
              ("config", ("use_depth", "use_descriptor", "baseline_fx", "cell_size",
                          "merge_dist_factor")),
              ("camera", ("cam",)), ("storage", ("storage",)), ("mesh", ("mesh",)))


def capture_reason(key: BAKey, replaced: Optional[BAKey]) -> str:
    """Why `key` is captured: "first" when no graph was held, else the parts
    of the key that differ from the graph it replaced (the last one it
    evicted, or else the last one held)."""
    if replaced is None:
        return "first"
    parts = [part for part, fields in _KEY_PARTS
             if any(getattr(key, f) != getattr(replaced, f) for f in fields)]
    return "+".join(parts) or "same key"


class BAGraph(GraphOwner):
    """The fused BA calls of one DirectBA on a CUDA device as CUDA graphs
    (module docstring)."""

    def __init__(self, device: torch.device):
        super().__init__(device)

        def scalar():
            return torch.zeros((), dtype=torch.int64, device=self.device)

        self.limit, self.ba_iter, self.min_obs = scalar(), scalar(), scalar()
        # Per keyframe bucket size: (slot list, device tensor).
        self._sel: Dict[int, tuple] = {}

    def _slots(self, sel: List[int]) -> torch.Tensor:
        """The static slot list of a bucket of len(sel) slots, holding sel
        (uploaded through pinned memory when it changed)."""
        held = self._sel.get(len(sel))
        if held is None:
            held = (None, torch.zeros(len(sel), dtype=torch.int64, device=self.device))
        if held[0] != sel:
            host = torch.tensor(sel, dtype=torch.int64).pin_memory()
            held[1].copy_(host, non_blocking=True)
            held = (list(sel), held[1])
            self._sel[len(sel)] = held
        return held[1]

    def _key(self, ba: DirectBA, sel, bucket: int, call: FusedCall) -> BAKey:
        c = ba.config
        ks, m = ba.keyframes, ba.surfels
        storage = (ks.generation, ks.depth.data_ptr(), ks.q.data_ptr(),
                   *(getattr(m, f).data_ptr() for f in m._fields))
        mesh = ()
        if ba.mesh is not None:
            storage += tuple(b.data_ptr() for blocks in ba._planes.blocks.values()
                             for b in blocks)
            mesh = (ba.mesh.devices, ba._streaming)
        return BAKey(call, ks.capacity if sel is None else len(sel), sel is None, bucket,
                     c.use_geometric_residuals, c.use_photometric_residuals,
                     c.baseline_fx, c.sparse_surfel_cell_size, c.surfel_merge_dist_factor,
                     ba.cam, storage, mesh)

    def run(self, ba: DirectBA, sel: Optional[List[int]], bucket: int,
            max_iterations: int, call: FusedCall) -> torch.Tensor:
        """Fill the static inputs and replay the graph of this call,
        capturing it first if there is none. Returns the iterations run, a
        device int64 scalar of its own. Over a mesh, every shard must be on
        this graph's device, and the planes brought up to date before."""
        if ba.mesh is not None and ba.mesh.distinct() != [self.device]:
            raise ValueError(f"a BA graph on {self.device} cannot hold a call over "
                             f"{ba.mesh}: its shards must all be on that card")
        sel_t = None if sel is None else self._slots(sel)
        self.limit.fill_(max_iterations)
        self.ba_iter.fill_(ba.ba_iteration_count)
        self.min_obs.fill_(ba.min_observation_count())
        key = self._key(ba, sel, bucket, call)
        captured = self._graphs.get(key)
        if captured is None:
            held = list(self._graphs)
            evicted = [k for k in held
                       if (k.keyframe_bucket, k.whole_capacity, k.surfel_bucket,
                           k.storage, k.cam, k.mesh)
                       != (key.keyframe_bucket, key.whole_capacity, key.surfel_bucket,
                           key.storage, key.cam, key.mesh)]
            for old in evicted:
                del self._graphs[old]
            shards = 1 if ba.mesh is None else ba.mesh.size
            # Library state made before the capture: the cuBLAS handle and the
            # workspaces of the capture's streams (one small product each).
            ones = torch.ones((2, 2), device=self.device)

            def work(control):
                return ba._fused_program(sf.prefix(ba.surfels, bucket), sel_t, self.limit,
                                         self.ba_iter, self.min_obs, call, control)

            captured = self._graphs[key] = self._capture(
                "BA call", "ba_graph", _bodies(key.keyframe_bucket, shards), work, depth=2,
                warm_up=lambda: ones @ ones,
                reason=capture_reason(key, (evicted or held or [None])[-1]),
                end_first=call.end_first, end_last=call.end_last, shards=shards,
                streamed=ba._streaming, keyframe_bucket=key.keyframe_bucket,
                surfel_bucket=bucket)
        self._replay(captured)
        return captured.outputs.clone()
