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
syncs and invalidates the capture. Captured and replayed as
``ops.conditional.GraphOwner`` does it (a capture failure raises;
``BadSlam.closure_graph = None`` asks for the eager call). A record of
``captures`` also holds its order bucket and refinements;
``replay_launches`` gives the launches of each replay (a device read, for
reports).

Timers (``utils.timing``): each replay is stamped on the card from its
first node to its last ("closure attempt [graph]", with a ring entry) and
each WHILE node ("closure attempt: gn/scale<s> [graph]"). The capture is
the profiler range "capture/closure_graph"; inside it the tracker's ranges
are left out.
"""

from __future__ import annotations

from collections import Counter
from typing import List

import torch

from badslam_torch.loop import closure
from badslam_torch.loop.closure import ClosureInputs, ClosureKey, ClosureResult
from badslam_torch.ops.conditional import GraphOwner


class ClosureGraph(GraphOwner):
    """The loop-closure attempts of one front end on a CUDA device as CUDA
    graphs (module docstring)."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        # Per replay: its graph's recorded launches and the device count of
        # its body runs before and after it.
        self._log: List[tuple] = []

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

            def work(control):  # the graph's outputs: its static inputs and the gates
                return inputs, closure.attempt_closure(key, cams, cam, ks, traj_q, traj_t,
                                                       count, inputs, loop=control)

            library = torch.backends.cuda.preferred_linalg_library()
            torch.backends.cuda.preferred_linalg_library("cusolver")
            try:
                # Library state made before the capture, on each capture
                # stream: the cuBLAS handle and workspace (one small product)
                # and the cuSOLVER handle (one small solve).
                ones = torch.eye(2, device=self.device)

                def warm_up():
                    ones @ ones
                    torch.linalg.solve_ex(ones, ones[0], check_errors=False)

                captured = self._graphs[gkey] = self._capture(
                    "closure attempt", "closure_graph", key.refinements * key.num_scales,
                    work, warm_up=warm_up, order_bucket=len(inputs.order),
                    refinements=key.refinements)
            finally:
                torch.backends.cuda.preferred_linalg_library(library)
        else:
            closure.upload(host, self.device, out=captured.outputs[0])
        units = captured.control.units
        before = units.clone()
        self._replay(captured)
        self._log.append((captured.launches, captured.control.body_launches, before,
                          units.clone()))
        return ClosureResult(*(x.clone() for x in captured.outputs[1]))

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
