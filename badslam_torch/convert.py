"""Carry state from the JAX package (as numpy arrays) into the port.

The SLAM system has no learned weights: its state is the camera, the
depth-deformation model, the keyframes and the surfel map. These helpers
turn the JAX package's values, read out as numpy arrays or host numbers,
into the port's types on an explicit device, so that tests can feed both
packages the same base keyframe, the same depth parameters, and the same
map and keyframes for one BA step, and the same camera and depth
parameters for one PCG or intrinsics step.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from badslam_torch.ba.intrinsics_opt import DepthParams
from badslam_torch.geometry.camera import PinholeCamera
from badslam_torch.geometry.se3 import SE3
from badslam_torch.mapping.keyframes import KeyframeStack, KeyframeStore
from badslam_torch.mapping.surfels import SurfelMap
from badslam_torch.ops.preprocess import ProcessedFrame
from badslam_torch.ops.pyramid import FramePyramidLevel


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def camera_from_numpy(cam) -> PinholeCamera:
    """Any camera with fx, fy, cx, cy, width, height attributes (e.g. the
    JAX package's PinholeCamera) -> the port's PinholeCamera."""
    return PinholeCamera(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx),
                         cy=float(cam.cy), width=int(cam.width),
                         height=int(cam.height))


def depth_params_from_numpy(a, cfactor, device) -> DepthParams:
    """Depth-deformation parameters: DepthParams(a [] f32, cfactor [Hc, Wc] f32)."""
    return DepthParams(_tensor(a, device), _tensor(cfactor, device))


def pyramid_from_numpy(levels: Sequence, device) -> Tuple[FramePyramidLevel, ...]:
    """Finest-first pyramid levels, each with depth/nx/ny/intensity planes."""
    return tuple(
        FramePyramidLevel(*(_tensor(getattr(lvl, name), device)
                            for name in FramePyramidLevel._fields))
        for lvl in levels)


def pose_from_numpy(q, t, device) -> SE3:
    """(q wxyz, t) -> SE3 of f32 tensors on `device`."""
    return SE3(_tensor(q, device), _tensor(t, device))


def frame_from_numpy(frame, device) -> ProcessedFrame:
    """A processed frame (depth, nx, ny, radius2, intensity and, where the
    source has them, raw_depth and rgb) -> the port's ProcessedFrame."""
    def opt(name, dtype=torch.float32):
        x = getattr(frame, name, None)
        return None if x is None else _tensor(x, device, dtype)

    return ProcessedFrame(
        *(_tensor(getattr(frame, n), device)
          for n in ("depth", "nx", "ny", "radius2", "intensity")),
        raw_depth=opt("raw_depth"), rgb=opt("rgb", torch.uint8))


def surfel_map_from_numpy(smap, device) -> SurfelMap:
    """A surfel map with the SurfelMap fields (pos, normal, radius2, color,
    desc, valid, active, count) -> the port's SurfelMap, same capacity."""
    f = {n: _tensor(getattr(smap, n), device)
         for n in ("pos", "normal", "radius2", "color", "desc")}
    return SurfelMap(valid=_tensor(smap.valid, device, torch.bool),
                     active=_tensor(smap.active, device, torch.bool),
                     count=_tensor(smap.count, device, torch.int64), **f)


def keyframe_stack_from_numpy(stack, device) -> KeyframeStack:
    """The planes, poses and mask of a keyframe stack -> KeyframeStack."""
    return KeyframeStack(
        *(_tensor(getattr(stack, n), device)
          for n in ("depth", "nx", "ny", "radius2", "intensity", "q", "t")),
        mask=_tensor(stack.mask, device, torch.bool))


def keyframe_store_from_numpy(store, cam: PinholeCamera, device) -> KeyframeStore:
    """A keyframe store (planes, poses, validity, activation, covisibility,
    depth range, BA counters and the host slot bookkeeping) -> the port's
    KeyframeStore holding the same slots [0, count)."""
    k = int(store.count)
    out = KeyframeStore(cam, device, capacity=max(1, k))
    if k == 0:
        return out
    int64 = ("activation", "last_active_iter", "last_covis_iter")
    for name in ("depth", "raw_depth", "nx", "ny", "radius2", "intensity", "rgb",
                 "q", "t", "valid", "min_depth", "max_depth") + int64:
        dst = getattr(out, name)
        dst[:k] = _tensor(np.asarray(getattr(store, name))[:k], device, dst.dtype)
    out.covis[:k, :k] = _tensor(np.asarray(store.covis)[:k, :k], device, torch.bool)
    out.count = k
    out.frame_indices = list(store.frame_indices[:k])
    out.free_slots = list(store.free_slots)
    return out
