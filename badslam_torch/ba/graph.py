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

Captured on a side stream with ``capture_error_mode="thread_local"``. A
capture or instantiation failure raises; nothing falls back to the eager
call (``BadSlam.ba_graph = None`` asks for the eager call).

Counts: the K2 launches of one replay outside the WHILE bodies are added
on the host per replay, and those of each body per run of it from a
device counter (``kernels.count_on_device``), so ``kernels.launch_counts``
stay exact with no read per call, per shard tag too (``launch_tags``: the
tag of a launch is recorded at the capture). Each replay's iteration count is copied
on the card and read with ``DirectBA.iterations_run`` (a report).
``captures`` holds one record per capture: its key's kind and buckets,
capture and instantiate seconds, node counts (all; kernel nodes; kernel
nodes outside the bodies and per body), WHILE nodes, the memory its pools
reserved, its replays and why it was captured (``capture_reason``).

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

import time
from collections import Counter
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

from badslam_torch.ba.scheme import DirectBA, FusedCall
from badslam_torch.mapping import surfels as sf
from badslam_torch.mapping.keyframes import KEYFRAME_BATCH
from badslam_torch.ops import kernels
from badslam_torch.ops.conditional import DeviceControl, WhileNodes, node_counts
from badslam_torch.utils.timing import Timing, stamped


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


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    nodes: WhileNodes          # keeps the bodies' memory pool alive
    iterations: torch.Tensor   # the replay's iteration count (graph memory)
    launches: Counter          # kernel launches of one replay outside the bodies
    record: dict               # its entry of BAGraph.captures


class BAGraph:
    """The fused BA calls of one DirectBA on a CUDA device as CUDA graphs
    (module docstring)."""

    def __init__(self, device: torch.device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"BAGraph runs on a CUDA device, not {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._graphs: Dict[BAKey, _Captured] = {}

        def scalar():
            return torch.zeros((), dtype=torch.int64, device=device)

        self.limit, self.ba_iter, self.min_obs = scalar(), scalar(), scalar()
        # Per keyframe bucket size: (slot list, device tensor).
        self._sel: Dict[int, tuple] = {}
        self.captures: List[dict] = []
        self.replays = 0
        Timing.stamp_table(device)

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
            reason = capture_reason(key, (evicted or held or [None])[-1])
            captured = self._graphs[key] = self._capture(ba, sel_t, bucket, call, key,
                                                         reason)
        kernels.add_launches(captured.launches)
        captured.graph.replay()
        captured.record["replays"] += 1
        self.replays += 1
        return captured.iterations.clone()

    def _capture(self, ba: DirectBA, sel_t, bucket: int, call: FusedCall,
                 key: BAKey, reason: str) -> _Captured:
        device = self.device
        current = torch.cuda.current_stream(device)
        stream = torch.cuda.Stream(device)
        nodes = WhileNodes(device, depth=2)
        # Library state made before the capture: the cuBLAS handle and the
        # workspaces of the capture's streams (one small product each).
        ones = torch.ones((2, 2), device=device)
        for s in (stream, *nodes.streams):
            s.wait_stream(current)
            with torch.cuda.stream(s):
                ones @ ones
            current.wait_stream(s)
        units = torch.zeros(_bodies(key.keyframe_bucket,
                                    1 if ba.mesh is None else ba.mesh.size),
                            dtype=torch.int64, device=device)
        control = DeviceControl(nodes, units, scope="BA call")
        launches: Counter = Counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        reserved = torch.cuda.memory_reserved(device)
        stream.wait_stream(current)
        t0 = time.perf_counter()
        try:
            with record_function("capture/ba_graph"), torch.cuda.stream(stream), \
                    kernels.count_into(launches):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    with stamped("BA call", device, ring=True):
                        iterations = ba._fused_program(
                            sf.prefix(ba.surfels, bucket), sel_t, self.limit,
                            self.ba_iter, self.min_obs, call, control)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                graph.capture_end()
            t1 = time.perf_counter()
            graph.instantiate()
        except Exception as e:
            raise RuntimeError(f"badslam_torch: capturing the BA call as a CUDA graph "
                               f"failed: {type(e).__name__}: {e}") from e
        t2 = time.perf_counter()
        current.wait_stream(stream)
        top, top_kernels = node_counts(graph.raw_cuda_graph())
        bodies = [node_counts(b) for b in control.body_graphs]
        body_kernels: Dict[str, List[int]] = {}
        for name, (_, k) in zip(control.body_names, bodies):
            body_kernels.setdefault(name, []).append(k)
        record = dict(
            reason=reason, end_first=call.end_first, end_last=call.end_last,
            shards=1 if ba.mesh is None else ba.mesh.size, streamed=ba._streaming,
            keyframe_bucket=key.keyframe_bucket, surfel_bucket=bucket,
            capture_s=t1 - t0, instantiate_s=t2 - t1,
            nodes=top + sum(b[0] for b in bodies),
            kernel_nodes=top_kernels + sum(b[1] for b in bodies),
            top_kernel_nodes=top_kernels, body_kernel_nodes=body_kernels,
            while_nodes=nodes.count,
            reserved_mib=(torch.cuda.memory_reserved(device) - reserved) / 2**20,
            replays=0)
        kernels.count_on_device(graph, units, control.body_launches)
        self.captures.append(record)
        return _Captured(graph, nodes, iterations, launches, record)
