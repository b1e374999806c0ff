"""Live RGB-D inputs: capture threads feeding a growing video.

Counterpart of ``badslam_tpu/io/live_inputs.py``: each input has
``start(max_frames, depth_scaling)``, which opens the source and starts a
capture thread that pushes frames into a `LiveRGBDVideo` while the SLAM
loop (``frontend.BadSlam.run_live``) consumes them.

  * `DirectoryInput` follows a directory that a camera process writes
    ``depth/*.png`` + ``rgb/*.png`` pairs into, picked up in filename
    order as they appear; a file named ``end`` ends the stream. PNGs
    decode through the dataset's readers (libpng where the native loader
    loads, else ``io/png.py``). A file still being written does not
    decode and is retried for up to 10 s.
  * `TCPInput` accepts a length-prefixed binary frame stream on a TCP
    socket (header: magic, width, height, intrinsics, timestamp; payload:
    u16 depth + u8 RGB); `send_frame` is the matching client encoder.

The vendor-SDK inputs (RealSense, Azure Kinect, Structure Core) raise at
``start()`` without their SDK, as the JAX package's do.

A capture thread that fails ends the stream with its error, and the
consumer's next `wait_for_frame` raises it: a failed capture never looks
like a stream that ended.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from badslam_torch.geometry.camera import PinholeCamera
from badslam_torch.io.dataset import _imread_color, _imread_depth

# Seconds DirectoryInput waits for calibration.txt and for a listed frame
# to decode (a file the producer is still writing), as the JAX package.
_DEADLINE_S = 10.0


class LiveRGBDVideo:
    """The front end's video interface over frames a capture thread pushes.

    `__len__` is the capacity (max_frames), so BadSlam sizes its trajectory
    buffers up front; `received` is the number of frames captured so far.
    The SLAM loop calls `wait_for_frame(i)`, which blocks until frame i
    exists or the stream ends. `push_times` holds each frame's
    `time.perf_counter()` at its push (the start of its capture-to-pose
    lag)."""

    undistortion_map = None  # live frames come from a pinhole camera

    def __init__(self, camera: PinholeCamera, max_frames: int = 10000):
        self.camera = camera
        self.depth_camera = camera
        self._max_frames = max_frames
        self._depths: List[np.ndarray] = []
        self._rgbs: List[np.ndarray] = []
        self.timestamps: List[float] = []
        self.push_times: List[float] = []
        self.poses: List[Optional[object]] = []
        self._cv = threading.Condition()
        self._ended = False
        self._error: Optional[BaseException] = None

    def __len__(self) -> int:
        return self._max_frames

    @property
    def received(self) -> int:
        with self._cv:
            return len(self._depths)

    # -- producer side (capture thread) --

    def push(self, timestamp: float, depth_u16: np.ndarray,
             rgb_u8: np.ndarray) -> bool:
        """Append one frame; returns False when capacity is exhausted."""
        with self._cv:
            if self._ended or len(self._depths) >= self._max_frames:
                return False
            self._depths.append(depth_u16)
            self._rgbs.append(rgb_u8)
            self.timestamps.append(timestamp)
            self.push_times.append(time.perf_counter())
            self.poses.append(None)
            self._cv.notify_all()
            return True

    def end_stream(self, error: Optional[BaseException] = None) -> None:
        """End the stream; with `error` the consumer's next wait raises it."""
        with self._cv:
            self._ended = True
            if error is not None and self._error is None:
                self._error = error
            self._cv.notify_all()

    # -- consumer side (SLAM loop) --

    def wait_for_frame(self, i: int, timeout: Optional[float] = None) -> bool:
        """Block until frame i is available; False on stream end or
        timeout. Raises RuntimeError if the capture thread failed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while len(self._depths) <= i:
                if self._error is not None:
                    raise RuntimeError(
                        f"live capture failed before frame {i}: {self._error}"
                    ) from self._error
                if self._ended or i >= self._max_frames:
                    return False
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining if remaining is not None else 0.5)
            return True

    def depth_u16(self, i: int) -> np.ndarray:
        with self._cv:
            return self._depths[i]

    def color_u8(self, i: int) -> np.ndarray:
        with self._cv:
            return self._rgbs[i]

    def set_pose(self, i: int, pose) -> None:
        self.poses[i] = pose

    def clear_frame(self, i: int) -> None:
        """Release a consumed frame's images: live frames cannot be
        reloaded."""
        with self._cv:
            self._depths[i] = _EMPTY_U16
            self._rgbs[i] = _EMPTY_U8


_EMPTY_U16 = np.zeros((0, 0), np.uint16)
_EMPTY_U8 = np.zeros((0, 0, 3), np.uint8)


class LiveInputBase:
    """Start/stop and the capture-thread lifecycle shared by all inputs."""

    name = "unknown"

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.video: Optional[LiveRGBDVideo] = None

    # subclasses: return the camera (probed from the device or stream).
    def _open(self) -> PinholeCamera:
        raise NotImplementedError

    # subclasses: block for one frame; None = end of stream.
    def _grab(self) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def _close(self) -> None:
        pass

    def start(self, max_frames: int = 10000,
              depth_scaling: float = 5000.0) -> LiveRGBDVideo:
        """Open the source and start the capture thread; returns the growing
        video the SLAM loop consumes. `depth_scaling` (raw depth units per
        meter) is the CLI's argument for sources that would deliver metric
        depth (the SDK inputs); the directory and TCP streams carry raw u16
        depth already and do not use it."""
        camera = self._open()
        self.video = LiveRGBDVideo(camera, max_frames)
        self._thread = threading.Thread(
            target=self._capture_loop, name=f"{self.name}-capture", daemon=True)
        self._thread.start()
        return self.video

    def _capture_loop(self) -> None:
        error = None
        try:
            while not self._stop.is_set():
                item = self._grab()
                if item is None:
                    break
                ts, depth, rgb = item
                if not self.video.push(ts, depth, rgb):
                    break
        except Exception as e:  # handed to the consumer, which raises it
            error = e
        finally:
            self.video.end_stream(error)
            self._close()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class DirectoryInput(LiveInputBase):
    """Follow a directory a camera process drops frames into.

    Layout: ``<path>/calibration.txt`` (fx fy cx cy), ``depth/*.png`` (u16)
    + ``rgb/*.png`` pairs matched by filename, picked up in sorted filename
    order as they appear. A file named ``end`` ends the stream. Timestamps
    come from the filename's stem when it is a number (e.g. 13.250.png),
    else from the depth file's mtime."""

    name = "DirectoryInput"

    def __init__(self, path: str, poll_interval: float = 0.02):
        super().__init__()
        self.path = path
        self.poll = poll_interval
        self._consumed: set = set()
        self._pending = None

    def _open(self) -> PinholeCamera:
        calib = os.path.join(self.path, "calibration.txt")
        deadline = time.monotonic() + _DEADLINE_S
        while not os.path.exists(calib):
            if time.monotonic() > deadline:
                raise RuntimeError(f"no calibration.txt in {self.path}")
            time.sleep(self.poll)
        with open(calib) as f:
            fx, fy, cx, cy = (float(v) for v in f.readline().split()[:4])
        # The first frame gives the image size.
        first = self._wait_for_pair()
        if first is None:
            raise RuntimeError(f"stream in {self.path} ended before the first frame")
        self._pending = self._decode(*first)
        h, w = self._pending[1].shape[:2]
        return PinholeCamera(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h)

    def _list_ready(self) -> List[Tuple[str, str, str]]:
        """Sorted (name, depth_path, rgb_path) of the names present in both
        directories and not consumed yet."""
        ddir = os.path.join(self.path, "depth")
        cdir = os.path.join(self.path, "rgb")
        if not (os.path.isdir(ddir) and os.path.isdir(cdir)):
            return []
        ready = sorted(set(os.listdir(ddir)) & set(os.listdir(cdir)) - self._consumed)
        return [(n, os.path.join(ddir, n), os.path.join(cdir, n)) for n in ready]

    def _wait_for_pair(self):
        while not self._stop.is_set():
            ready = self._list_ready()
            if ready:
                self._consumed.add(ready[0][0])
                return ready[0]
            if os.path.exists(os.path.join(self.path, "end")):
                # Late files may have landed together with the sentinel.
                if not self._list_ready():
                    return None
                continue
            time.sleep(self.poll)
        return None

    def _decode(self, name: str, dp: str, cp: str):
        """(timestamp, depth, rgb) of one listed pair. A file the producer
        is still writing does not decode (png.py raises ValueError on a
        file cut before IEND, libpng fails on it): retried until the
        deadline, then RuntimeError. Never decoded as a short image."""
        deadline = time.monotonic() + _DEADLINE_S
        while True:
            try:
                depth, rgb = _imread_depth(dp), _imread_color(cp)
                break
            except (ValueError, OSError) as e:
                if self._stop.is_set():
                    return None
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{self.name}: frame {name} did not decode within "
                        f"{_DEADLINE_S:.0f} s: {e}") from e
                time.sleep(self.poll)
        stem = os.path.splitext(name)[0]
        try:
            ts = float(stem)
        except ValueError:
            ts = os.path.getmtime(dp)
        return ts, depth, rgb

    def _grab(self):
        if self._pending is not None:
            item, self._pending = self._pending, None
            return item
        pair = self._wait_for_pair()
        if pair is None:
            return None
        return self._decode(*pair)


_TCP_MAGIC = b"BDSF"
_TCP_HEADER = struct.Struct("<4sII4fd")  # magic, w, h, fx fy cx cy, ts


def send_frame(sock: socket.socket, timestamp: float, depth_u16: np.ndarray,
               rgb_u8: np.ndarray, camera: PinholeCamera) -> None:
    """Client-side encoder of TCPInput's wire format."""
    h, w = depth_u16.shape
    sock.sendall(_TCP_HEADER.pack(_TCP_MAGIC, w, h, camera.fx, camera.fy,
                                  camera.cx, camera.cy, timestamp))
    sock.sendall(np.ascontiguousarray(depth_u16, np.uint16).tobytes())
    sock.sendall(np.ascontiguousarray(rgb_u8, np.uint8).tobytes())


class TCPInput(LiveInputBase):
    """Binary RGB-D frame stream over TCP (one producer connection).

    Wire format per frame: `<4sII4fd` header (magic "BDSF", width, height,
    fx fy cx cy, timestamp), then width*height u16 depth and
    width*height*3 u8 RGB. The stream ends when the peer closes."""

    name = "TCPInput"

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        super().__init__()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._conn: Optional[socket.socket] = None
        self._first = None

    def _recv_exact(self, n: int) -> Optional[bytearray]:
        """n bytes, or None when the peer closes first. A bytearray, so the
        images viewing it are writable."""
        buf = bytearray()
        while len(buf) < n:
            chunk = self._conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _read_frame(self):
        raw = self._recv_exact(_TCP_HEADER.size)
        if raw is None:
            return None
        magic, w, h, fx, fy, cx, cy, ts = _TCP_HEADER.unpack(raw)
        if magic != _TCP_MAGIC:
            raise RuntimeError("TCPInput: bad frame magic")
        dbuf = self._recv_exact(w * h * 2)
        cbuf = self._recv_exact(w * h * 3)
        if dbuf is None or cbuf is None:
            return None
        depth = np.frombuffer(dbuf, np.uint16).reshape(h, w)
        rgb = np.frombuffer(cbuf, np.uint8).reshape(h, w, 3)
        cam = PinholeCamera(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h)
        return ts, depth, rgb, cam

    def _open(self) -> PinholeCamera:
        self._srv.settimeout(30.0)
        self._conn, _ = self._srv.accept()
        first = self._read_frame()
        if first is None:
            raise RuntimeError("TCPInput: stream ended before the first frame")
        ts, depth, rgb, cam = first
        self._first = (ts, depth, rgb)
        return cam

    def _grab(self):
        if self._first is not None:
            item, self._first = self._first, None
            return item
        frame = self._read_frame()
        if frame is None:
            return None
        return frame[:3]

    def _close(self) -> None:
        if self._conn is not None:
            self._conn.close()
        self._srv.close()


class _SDKInputBase(LiveInputBase):
    """Vendor-SDK inputs: the same thread machinery, an SDK-gated open.

    `config` (the port's BadSlamConfig, or None for its defaults) carries
    the vendor parameters (k4a_*, structure_*); each subclass names its own
    in CONFIG_FIELDS and `_sdk_options` extracts them."""

    CONFIG_FIELDS: Tuple[str, ...] = ()

    def __init__(self, config=None):
        super().__init__()
        self.config = config

    def _sdk_options(self) -> dict:
        if self.config is None:
            from badslam_torch.config import BadSlamConfig

            self.config = BadSlamConfig()
        return {f: getattr(self.config, f) for f in self.CONFIG_FIELDS}

    def _import_sdk(self):
        raise NotImplementedError

    def _open(self) -> PinholeCamera:
        opts = self._sdk_options()
        try:
            self._sdk = self._import_sdk()
        except ImportError as e:
            raise RuntimeError(
                f"{self.name} support requires its SDK, which is not "
                f"installed in this environment (the reference behaves the "
                f"same when compiled without the SDK): {e}"
            ) from e
        raise NotImplementedError(
            f"{self.name}: device binding requires the vendor SDK runtime "
            f"(configured options: {opts})")


class RealSenseInputThread(_SDKInputBase):
    """Intel RealSense D400-series input; no config parameters of its own."""

    name = "RealSense"

    def _import_sdk(self):
        import pyrealsense2

        return pyrealsense2


class K4AInputThread(_SDKInputBase):
    """Azure Kinect input, with .mkv recording."""

    name = "AzureKinect"
    CONFIG_FIELDS = ("k4a_mode", "k4a_fps", "k4a_resolution", "k4a_factor",
                     "k4a_use_ir", "k4a_exposure", "k4a_record_path")

    def _import_sdk(self):
        import pyk4a

        return pyk4a


class StructureInputThread(_SDKInputBase):
    """Occipital Structure Core input."""

    name = "StructureCore"
    CONFIG_FIELDS = (
        "structure_depth_range", "structure_depth_only",
        "structure_depth_resolution", "structure_expensive_correction",
        "structure_one_shot_dynamic_calibration",
        "structure_depth_diff_threshold",
        "structure_infrared_auto_exposure",
        "structure_visible_exposure_time")

    def _import_sdk(self):
        raise ImportError("no Python SDK exists for Structure Core")


def open_live_input(spec: str, config=None):
    """The CLI's dispatch: 'dir:<path>', 'tcp:<port>', 'realsense', 'k4a'
    (or 'azurekinect'), 'structure'. `config` supplies the vendor
    parameters."""
    if spec.startswith("dir:"):
        return DirectoryInput(spec[4:])
    if spec.startswith("tcp:"):
        return TCPInput(port=int(spec[4:]))
    name = spec.lower()
    if name == "realsense":
        return RealSenseInputThread(config)
    if name in ("k4a", "azurekinect"):
        return K4AInputThread(config)
    if name == "structure":
        return StructureInputThread(config)
    raise ValueError(f"unknown live input '{spec}'")
