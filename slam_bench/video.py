"""The rendered sequence behind the program's video interface, and the
record of every pose the program writes.

``FrameStore`` is what ``badslam_torch.frontend.BadSlam`` reads a recorded
dataset through (the attributes and methods of ``io.dataset.RGBDVideo``
that the front end uses): ``camera``, ``undistortion_map`` (None: the
frames are pinhole), ``__len__``, ``depth_u16``, ``color_u8``,
``set_pose``, ``clear_frame``, ``poses`` and ``timestamps``. It has no
``wait_for_frame``, so the program sees a recorded sequence of known
length, pre-sizes its keyframe store for it and chunks steady frames as it
does for a dataset. The frames stay on the host for the whole run (the
reference reads them after the window), so ``clear_frame`` keeps them.

``PoseLog`` is the benchmark's own clock of the frame loop: at each
``set_pose`` (the program has just queued the work that writes frame i's
pose) it records a CUDA event on the current stream, with the pose (the
program's tensors, which it does not write again). The events time each
frame from the previous frame's pose to its own on the device's clock;
the poses are what the reference checks. It reads nothing else of the
program.

The sequence is as long as the recording the configuration states (the
program pre-sizes its keyframe store by ``len``), but only the frames the
run reads (warm-up and window) are rendered and held.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch


class PoseLog:
    """Per frame, in the order the program writes them: (frame, q, t, CUDA
    event or host seconds)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.entries: List[tuple] = []

    def mark(self):
        """A point on the device's timeline (a recorded CUDA event on the
        current stream), or the host clock on the CPU."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    def written(self, index: int, pose) -> None:
        self.entries.append((index, pose.q, pose.t, self.mark()))


def elapsed_ms(a, b) -> float:
    """Milliseconds from mark `a` to mark `b` (events must have completed)."""
    if isinstance(a, float):
        return 1e3 * (b - a)
    return a.elapsed_time(b)


class FrameStore:
    """A rendered RGB-D sequence as the program's recorded video of `length`
    frames, of which the first len(depth_u16) are rendered."""

    def __init__(self, camera, depth_u16: np.ndarray, color_u8: np.ndarray,
                 rate_hz: float, first_pose, length: int, log: Optional[PoseLog] = None):
        self.camera = camera
        self.undistortion_map = None
        self._depth = depth_u16
        self._color = color_u8
        self._length = length
        self.timestamps = [i / rate_hz for i in range(length)]
        # The first frame's pose prior (the ground truth's), so that the
        # program's world is the renderer's.
        self.poses = [first_pose] + [None] * (length - 1)
        self.log = log

    def __len__(self) -> int:
        return self._length

    def depth_u16(self, index: int) -> np.ndarray:
        return self._depth[index]

    def color_u8(self, index: int) -> np.ndarray:
        return self._color[index]

    def clear_frame(self, index: int) -> None:
        """The frames are kept for the reference."""

    def set_pose(self, index: int, pose) -> None:
        self.poses[index] = pose
        if self.log is not None:
            self.log.written(index, pose)
