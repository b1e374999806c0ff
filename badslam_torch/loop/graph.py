"""A loop-closure attempt as one CUDA graph per attempt, with its
Gauss-Newton exits and its accept decision on the card.

Counterpart of the JAX package's read-free closure (``badslam_tpu/
frontend.py:987-1080`` with ``loop/closure_device.py:100-145``): one replay
of a captured CUDA graph of ``loop.closure.attempt_closure`` holds the
current keyframe's pyramid, the refinements (each pyramid level's
Gauss-Newton loop one WHILE node, ``ops.conditional``: refinements x
num_scales bodies, none nested), the consistency and necessity gates, the
pose graph over the padded live order, the gated in-place write of the
keyframe poses and the trajectory, and the device closure counter. So no
value is read back between the keyframe's upload and the next frame.

Each graph owns its static inputs (``closure.ClosureInputs``: the padded
order and its live length, the positions and slots, RANSAC's pose, the
padded keypoints and the deformation brackets), filled from the host
through pinned memory before each replay. The key holds the attempt's
configuration (``closure.ClosureKey``, with the number of refinements), the
order bucket, the keypoint capacity, the trajectory's length and storage,
the counter's storage, the store's ``generation`` and the data pointers of
its poses and images, and the cameras (their intrinsics are host floats
baked into the graph). A capture whose bucket, storage or cameras differ
from a held graph's frees that graph and its pools.

The pose graph's dense solve is ``torch.linalg.solve_ex`` on cuSOLVER
(``getrf``/``getrs``), which is selected around the capture: a probe on
the H100 showed it captures and replays with no sync, where the MAGMA path
syncs and invalidates the capture. Captured on a side stream with
``capture_error_mode="thread_local"``. A capture or instantiation failure
raises; nothing falls back to the eager call (``BadSlam.closure_graph =
None`` asks for the eager call).

Counts: the K2 launches of a replay outside the WHILE bodies are added on
the host per replay, and those of each body per run of it from a device
counter (``kernels.count_on_device``), so ``kernels.launch_counts`` stay
exact with no read. ``captures`` holds one record per capture: its bucket
and refinements, capture and instantiate seconds, node counts (all; kernel
nodes; kernel nodes outside the bodies and per body), WHILE nodes, the
memory its pools reserved and its replays; ``replay_launches`` the launches
of each replay (a device read, for reports).

Timers (``utils.timing``): each replay is stamped on the card from its
first node to its last ("closure attempt [graph]", with a ring entry) and
each WHILE node ("closure attempt: gn/scale<s> [graph]"). The capture is
the profiler range "capture/closure_graph"; inside it the tracker's ranges
are left out.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, NamedTuple

import torch
from torch.profiler import record_function

from badslam_torch.loop import closure
from badslam_torch.loop.closure import ClosureInputs, ClosureKey, ClosureResult
from badslam_torch.ops import kernels
from badslam_torch.ops.conditional import DeviceControl, WhileNodes, node_counts
from badslam_torch.utils.timing import Timing, stamped


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    nodes: WhileNodes        # keeps the bodies' memory pool alive
    inputs: ClosureInputs    # the static inputs
    result: ClosureResult    # the gates' outcomes (graph memory)
    units: torch.Tensor      # runs of each WHILE body since the capture
    body_launches: list      # kernel launches of one run of each body
    launches: Counter        # kernel launches of one replay outside the bodies
    record: dict             # its entry of ClosureGraph.captures


class ClosureGraph:
    """The loop-closure attempts of one front end on a CUDA device as CUDA
    graphs (module docstring)."""

    def __init__(self, device: torch.device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"ClosureGraph runs on a CUDA device, not {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._graphs: Dict[tuple, _Captured] = {}
        self.captures: List[dict] = []
        self.replays = 0
        # Per replay: its graph's recorded launches and the device count of
        # its body runs before and after it.
        self._log: List[tuple] = []
        Timing.stamp_table(device)

    @staticmethod
    def _storage(ks, traj_q, traj_t, count) -> tuple:
        return (ks.generation, ks.q.data_ptr(), ks.t.data_ptr(), ks.depth.data_ptr(),
                ks.nx.data_ptr(), ks.ny.data_ptr(), ks.intensity.data_ptr(),
                traj_q.data_ptr(), traj_t.data_ptr(), count.data_ptr())

    def run(self, key: ClosureKey, cams, cam, ks, traj_q: torch.Tensor,
            traj_t: torch.Tensor, count: torch.Tensor, host: ClosureInputs) -> ClosureResult:
        """Fill the static inputs from the host arrays `host` and replay the
        graph of this attempt, capturing it first if there is none. Writes
        the store's poses, the trajectory and `count` in place; returns the
        gates' outcomes as device bools of their own."""
        shapes = (len(host.order), len(host.pts), len(host.alpha))
        gkey = (key, shapes, self._storage(ks, traj_q, traj_t, count), cam, tuple(cams))
        captured = self._graphs.get(gkey)
        if captured is None:
            for old in [k for k in self._graphs if k[1:] != gkey[1:]]:
                del self._graphs[old]
            inputs = closure.upload(host, self.device)
            captured = self._graphs[gkey] = self._capture(key, cams, cam, ks, traj_q,
                                                          traj_t, count, inputs)
        else:
            closure.upload(host, self.device, out=captured.inputs)
        before = captured.units.clone()
        kernels.add_launches(captured.launches)
        captured.graph.replay()
        self._log.append((captured.launches, captured.body_launches, before,
                          captured.units.clone()))
        captured.record["replays"] += 1
        self.replays += 1
        return ClosureResult(*(x.clone() for x in captured.result))

    def _capture(self, key: ClosureKey, cams, cam, ks, traj_q, traj_t, count,
                 inputs: ClosureInputs) -> _Captured:
        device = self.device
        current = torch.cuda.current_stream(device)
        stream = torch.cuda.Stream(device)
        nodes = WhileNodes(device)
        units = torch.zeros(key.refinements * key.num_scales, dtype=torch.int64,
                            device=device)
        control = DeviceControl(nodes, units, scope="closure attempt")
        launches: Counter = Counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        reserved = torch.cuda.memory_reserved(device)
        library = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            # Library state made before the capture, on each capture stream:
            # the cuBLAS handle and workspace (one small product) and the
            # cuSOLVER handle (one small solve).
            ones = torch.eye(2, device=device)
            for s in (stream, *nodes.streams):
                s.wait_stream(current)
                with torch.cuda.stream(s):
                    ones @ ones
                    torch.linalg.solve_ex(ones, ones[0], check_errors=False)
                current.wait_stream(s)
            stream.wait_stream(current)
            t0 = time.perf_counter()
            with record_function("capture/closure_graph"), torch.cuda.stream(stream), \
                    kernels.count_into(launches):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    with stamped("closure attempt", device, ring=True):
                        result = closure.attempt_closure(key, cams, cam, ks, traj_q,
                                                         traj_t, count, inputs,
                                                         loop=control)
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
            raise RuntimeError(f"badslam_torch: capturing the loop-closure attempt as a "
                               f"CUDA graph failed: {type(e).__name__}: {e}") from e
        finally:
            torch.backends.cuda.preferred_linalg_library(library)
        t2 = time.perf_counter()
        current.wait_stream(stream)
        top, top_kernels = node_counts(graph.raw_cuda_graph())
        bodies = [node_counts(b) for b in control.body_graphs]
        record = dict(
            order_bucket=len(inputs.order), refinements=key.refinements,
            capture_s=t1 - t0, instantiate_s=t2 - t1,
            nodes=top + sum(b[0] for b in bodies),
            kernel_nodes=top_kernels + sum(b[1] for b in bodies),
            top_kernel_nodes=top_kernels, body_kernel_nodes=[b[1] for b in bodies],
            while_nodes=nodes.count,
            reserved_mib=(torch.cuda.memory_reserved(device) - reserved) / 2**20,
            replays=0)
        kernels.count_on_device(graph, units, control.body_launches)
        self.captures.append(record)
        return _Captured(graph, nodes, inputs, result, units, control.body_launches,
                         launches, record)

    def replay_launches(self) -> List[Counter]:
        """The kernel launches of each replay so far, by (name, shape, tag)
        (a device read: for reports after a run)."""
        out = []
        for launches, body_launches, before, after in self._log:
            runs = (after - before).tolist()
            counter = Counter(launches)
            for n, recorded in zip(runs, body_launches):
                for k, v in recorded.items():
                    counter[k] += n * v
            out.append(counter)
        return out
