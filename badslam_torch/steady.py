"""The steady frame: every tracked frame at input level 0 as one device
program, with no host read between the frame's upload and the next frame.

Counterpart of the JAX package's fused steady-frame program
(``badslam_tpu/frontend.py`` ``_steady_frame_fn``, :92-160) and of its
between-keyframes scan chunk (``_chunk_frames_fn``, :163-236).

``steady_frame`` is the frame's function of tensors, with the JAX
program's inputs and outputs: preprocess (K1, and undistortion and the
median filter where configured), the pyramid, the constant-motion model,
the multi-scale tracker (K2 in its bilinear taps), then the global pose
base * rel, its trajectory write at `idx` and the motion-history shift. It
writes the trajectory and the history in place (the JAX program donates
those buffers) and returns them. On the CPU the front end calls it eagerly
with the host-read Gauss-Newton loop.

``SteadyFrameGraph`` runs it on a CUDA device as one CUDA graph per frame:
it holds the graph's static inputs (the frame's raw depth and color, the
base keyframe's pyramid and pose, the motion history, the trajectory, the
trajectory index as a device int, the depth deformation), captures
``steady_frame`` once per key and replays it. Each pyramid level's
Gauss-Newton loop is captured as one WHILE node whose body is one iteration
(``ops.conditional.DeviceControl``), so the early exit is decided on the
card. The key is
the JAX package's ``_steady_key`` (``SteadyKey``) plus the frame's shape,
the undistortion map, ``test_two``, the cameras (their intrinsics are host
floats baked into the graph, so self-calibration captures anew) and K1's
tile (``--autotune``: a new stored tile captures anew). A capture or
instantiation failure raises; nothing falls back to the host loop.

A replay's outputs live in the graph's memory and are overwritten by its
next replay: the caller copies what it keeps (the front end clones the
global pose, and the base keyframe's pyramid is copied into the static
input before the next replay). A chunk of steady frames (``upload_chunk``,
``set_frame``) uploads its frames in one batched copy and queues one replay
per frame, with no host read in between, as the JAX scan chunk's two
batched uploads and one program.

Timers (``utils.timing``): each replay is stamped on the card from its
first node to its last ("steady frame [graph]", with an entry per replay in
the stamp table's ring holding the frame index), its preprocessing and
pyramid from the first node of ``preprocess_frame`` to the last of
``build_pyramid`` ("steady frame: preprocess [graph]") and each scale's
WHILE node ("steady frame: gn/scale<s> [graph]"); the host's time inside
``graph.replay()`` is "steady frame launch [host]". Inside the capture the
profiler ranges of the frame's stages are left out, and the capture itself
is the range "capture/steady_graph".
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from badslam_torch.config import BadSlamConfig
from badslam_torch.geometry import se3
from badslam_torch.ops import kernels
from badslam_torch.ops.conditional import HOST, Control, DeviceControl, GraphOwner
from badslam_torch.ops.preprocess import ProcessedFrame, preprocess_frame
from badslam_torch.ops.pyramid import FramePyramidLevel, build_pyramid
from badslam_torch.tracking.pairwise import track_frame_pairwise
from badslam_torch.utils.timing import stamped, trace_range


class SteadyKey(NamedTuple):
    """The configuration a steady frame depends on (the JAX package's
    ``_steady_key``, badslam_tpu/frontend.py:353-360, in its order)."""
    max_depth: float
    sigma_xy: float
    radius_factor: float
    sigma_inv_depth: float
    cell_size: int
    raw_to_float: float
    num_scales: int
    use_gradmag: bool
    baseline_fx: float
    use_depth: bool
    use_descriptor: bool
    use_motion_model: bool
    max_iterations: int
    median_iterations: int


def steady_key(c: BadSlamConfig) -> SteadyKey:
    return SteadyKey(
        c.max_depth, c.bilateral_filter_sigma_xy, c.bilateral_filter_radius_factor,
        c.bilateral_filter_sigma_inv_depth, c.sparse_surfel_cell_size,
        c.raw_to_float_depth, c.num_scales, c.use_gradmag, c.baseline_fx,
        c.use_geometric_residuals,
        c.use_photometric_residuals and not c.use_gradmag,
        c.use_motion_model, c.tracking_max_iterations,
        c.median_filter_and_densify_iterations)


class SteadyOutputs(NamedTuple):
    frame: ProcessedFrame
    pyramid: Tuple[FramePyramidLevel, ...]
    traj_q: torch.Tensor
    traj_t: torch.Tensor
    hist_q: torch.Tensor
    hist_t: torch.Tensor
    q: torch.Tensor  # global_T_frame
    t: torch.Tensor
    # Gauss-Newton iterations per scale (see TrackingResult.iterations).
    iterations: tuple


def steady_frame(key: SteadyKey, cam, cams, base_pyr, depth_raw, rgb, undistort_map,
                 a, cfactor, base_q, base_t, traj_q, traj_t, hist_q, hist_t, idx,
                 *, test_two: bool, loop: Control = HOST) -> SteadyOutputs:
    """One steady frame (badslam_tpu/frontend.py:109-157). `depth_raw` is the
    raw depth as an integer tensor (scaled by key.raw_to_float), `rgb` u8
    [H, W, 3], `idx` the frame's trajectory row as a device int tensor of
    one element. `test_two` duels the two motion-model estimates at the
    coarsest scale (the history holds 3 poses). `loop`: the Gauss-Newton
    loop control (tracking.pairwise)."""
    with stamped("steady frame: preprocess", depth_raw.device):
        with trace_range("preprocess"):
            frame = preprocess_frame(
                cam, depth_raw, rgb,
                max_depth=key.max_depth, sigma_xy=key.sigma_xy,
                radius_factor=key.radius_factor, sigma_inv_depth=key.sigma_inv_depth,
                a=a, cfactor=cfactor, cell_size=key.cell_size,
                raw_to_float_depth=key.raw_to_float, undistort_map=undistort_map,
                median_iterations=key.median_iterations)
        with trace_range("pyramid"):
            pyramid = build_pyramid(frame.depth, frame.nx, frame.ny, frame.intensity,
                                    key.num_scales, gradmag=key.use_gradmag)
    # Constant-motion model (PredictFramePose, bad_slam.cc:767-829). The
    # history is identity-padded at a keyframe, so the full formula gives
    # the short-history cases exactly, as in the JAX program.
    last = se3.SE3(hist_q[2], hist_t[2])
    if not key.use_motion_model:
        e1 = e2 = last
    else:
        prev = se3.SE3(hist_q[1], hist_t[1])
        e1 = se3.mul(last, se3.mul(se3.inverse(prev), last))
        if test_two:
            pprev = se3.SE3(hist_q[0], hist_t[0])
            pm = se3.mul(se3.inverse(pprev), prev)
            e2 = se3.mul(prev, se3.mul(pm, pm))
        else:
            e2 = e1
    with trace_range("track"):
        res = track_frame_pairwise(
            cams, base_pyr, pyramid, e1.q, e1.t, e2.q, e2.t,
            baseline_fx=key.baseline_fx, use_depth=key.use_depth,
            use_descriptor=key.use_descriptor, use_gradmag=key.use_gradmag,
            test_two_initial_estimates=test_two, max_iterations=key.max_iterations,
            loop=loop)
    g = se3.mul(se3.SE3(base_q, base_t), se3.SE3(res.q, res.t))
    row = idx.reshape(1)
    traj_q.index_copy_(0, row, g.q[None])
    traj_t.index_copy_(0, row, g.t[None])
    hist_q.copy_(torch.cat([hist_q[1:], res.q[None]]))
    hist_t.copy_(torch.cat([hist_t[1:], res.t[None]]))
    return SteadyOutputs(frame, pyramid, traj_q, traj_t, hist_q, hist_t, g.q, g.t,
                         res.iterations)


class _GraphKey(NamedTuple):
    steady: SteadyKey
    cam: object
    cams: tuple
    undistorted: bool
    test_two: bool
    tile: tuple
    shape: tuple  # the raw depth's


def capture_reason(key: _GraphKey, last: Optional[_GraphKey]) -> str:
    """Why `key` is captured: "first", or the fields in which it differs
    from the last key captured (the SteadyKey's own fields by name)."""
    if last is None:
        return "first"
    parts = []
    for field, a, b in zip(key._fields, key, last):
        if a == b:
            continue
        if field == "steady":
            parts += [f for f, x, y in zip(a._fields, a, b) if x != y]
        else:
            parts.append(field)
    return "+".join(parts) or "same key"


class SteadyFrameGraph(GraphOwner):
    """The steady frame as one CUDA graph per frame on one CUDA device, for
    one front end (module docstring). ``captures`` holds one record per
    capture (``GraphOwner``), with its key's test_two and why it was
    captured (``capture_reason``); its bodies are the scales' Gauss-Newton
    loops, coarsest first."""

    launch_timer = "steady frame launch [host]"

    def __init__(self, device: torch.device):
        super().__init__(device)
        self._static: Dict[str, torch.Tensor] = {}
        self.base_pyr: Optional[Tuple[FramePyramidLevel, ...]] = None
        self.idx = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._last_key: Optional[_GraphKey] = None
        # Each capture's device count of Gauss-Newton bodies run per scale,
        # coarsest first.
        self._iterations: List[torch.Tensor] = []

    # -- static inputs ---------------------------------------------------

    def _hold(self, name: str, given: torch.Tensor, non_blocking: bool = False) -> torch.Tensor:
        """The static buffer `name`, holding `given`'s values: `given`
        itself when it is the buffer, else a copy into it (from the host or
        the device). A buffer of another shape or type is made anew, which
        drops the graphs captured on the old one."""
        static = self._static.get(name)
        if static is None or static.shape != given.shape or static.dtype != given.dtype:
            self._graphs.clear()
            static = self._static[name] = torch.empty(given.shape, dtype=given.dtype,
                                                      device=self.device)
        if given is not static:
            static.copy_(given, non_blocking=non_blocking)
        return static

    def upload(self, depth_u16: np.ndarray, rgb: np.ndarray) -> None:
        """Copy one frame's raw depth and color from the host into the static
        inputs, through pinned memory, without waiting for the copies."""
        depth = torch.from_numpy(depth_u16.astype(np.int32)).pin_memory()
        color = torch.from_numpy(np.ascontiguousarray(rgb)).pin_memory()
        self.set_frame(depth, color)

    def upload_chunk(self, depths: List[np.ndarray], rgbs: List[np.ndarray]):
        """Upload a chunk's frames as one batch each (raw depth [N, H, W]
        int32, color [N, H, W, 3] u8), through pinned memory, without
        waiting; returns the device batches for set_frame."""
        depth = torch.from_numpy(np.stack(depths).astype(np.int32)).pin_memory()
        color = torch.from_numpy(np.stack(rgbs)).pin_memory()
        return (depth.to(self.device, non_blocking=True),
                color.to(self.device, non_blocking=True))

    def set_frame(self, depth: torch.Tensor, rgb: torch.Tensor) -> None:
        """Make (depth, rgb), on the host (pinned) or on the device, the
        next replay's frame."""
        self._hold("depth_raw", depth, non_blocking=True)
        self._hold("rgb", rgb, non_blocking=True)

    def _bind(self, base_pyr, base_q, base_t, a, cfactor, traj_q, traj_t, hist_q,
              hist_t) -> None:
        if base_pyr is not self.base_pyr:
            self.base_pyr = tuple(
                FramePyramidLevel(*(self._hold(f"base{s}_{f}", plane)
                                    for f, plane in zip(level._fields, level)))
                for s, level in enumerate(base_pyr))
        for name, given in (("base_q", base_q), ("base_t", base_t), ("a", a),
                            ("cfactor", cfactor), ("traj_q", traj_q),
                            ("traj_t", traj_t), ("hist_q", hist_q), ("hist_t", hist_t)):
            self._hold(name, given)

    # -- capture and replay ------------------------------------------------

    def run(self, key: SteadyKey, cam, cams, undistort_map, *, test_two: bool,
            frame_index: int, base_pyr, base_q, base_t, a, cfactor, traj_q, traj_t,
            hist_q, hist_t) -> SteadyOutputs:
        """Bind the state (copies into the static inputs where the given
        tensors are not those already), set the trajectory index and replay
        the graph of this key, capturing it first if there is none. The
        frame is the last one given to upload or set_frame. Returns the
        graph's outputs; traj_q, traj_t, hist_q, hist_t and base_pyr are the
        static buffers, which the caller may keep as its state."""
        self._bind(base_pyr, base_q, base_t, a, cfactor, traj_q, traj_t, hist_q, hist_t)
        self.idx.fill_(frame_index)
        h, w = cams[0].height, cams[0].width
        tile = kernels._tile_index(None, self.device, h, w)[1]
        gkey = _GraphKey(key, cam, tuple(cams), undistort_map is not None, test_two, tile,
                         tuple(self._static["depth_raw"].shape))
        captured = self._graphs.get(gkey)
        if captured is None:
            reason = capture_reason(gkey, self._last_key)
            self._last_key = gkey
            st = self._static

            def work(control: DeviceControl) -> SteadyOutputs:
                return steady_frame(
                    key, cam, cams, self.base_pyr, st["depth_raw"], st["rgb"], undistort_map,
                    st["a"], st["cfactor"], st["base_q"], st["base_t"], st["traj_q"],
                    st["traj_t"], st["hist_q"], st["hist_t"], self.idx, test_two=test_two,
                    loop=control)

            # The frame calls no library that keeps state (its tracker is H1),
            # and its kernels are not run ahead: that would launch each once
            # more per capture than the frames need. One WHILE body per scale.
            captured = self._graphs[gkey] = self._capture(
                "steady frame", "steady_graph", key.num_scales, work, frame=self.idx,
                test_two=test_two, reason=reason)
            self._iterations.append(captured.control.units)
        self._replay(captured)
        return captured.outputs

    def gn_iterations(self) -> int:
        """Gauss-Newton iterations run on the card by this front end's
        replays, all scales (a device read)."""
        return sum(int(it.sum()) for it in self._iterations)

    def kernel_nodes_run(self) -> int:
        """The kernel nodes the card ran in this front end's replays: per
        replay those outside the WHILE bodies, per run of a body its own
        (a device read)."""
        total = 0
        for record, units in zip(self.captures, self._iterations):
            total += record["replays"] * record["top_kernel_nodes"] + sum(
                n * k for n, (_, k) in zip(units.tolist(), record["body_kernel_nodes"]))
        return total
