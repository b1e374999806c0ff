"""RGB-D dataset IO: TUM / ETH3D format with lazy frame loading.

Counterpart of ``badslam_tpu/io/dataset.py``. Expected directory layout:

  dataset/
    calibration.txt     # "[model] fx fy cx cy [distortion...]" (pixel-corner)
    associated.txt      # "rgb_ts rgb_file depth_ts depth_file" per line, or
    rgb.txt, depth.txt  # a raw TUM download's lists, associated here
    rgb/*.png, depth/*.png (16-bit, raw_to_float scaling, default 1/5000)
    [trajectory file]   # optional TUM format "ts tx ty tz qx qy qz qw"

Images decode with libpng through ``io/native_loader.py`` where its
library loads, else through ``io/png.py`` (zlib + numpy). Poses are host numpy
``se3.SE3`` pairs (q wxyz, t), float32. For a distorted calibration
(radial-tangential or thin-prism fisheye) the video's camera is the pinhole
covering the source's field of view and ``undistortion_map`` holds the
[H, W, 2] remap table that preprocessing applies on the device.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from badslam_torch.geometry.camera import (
    PinholeCamera,
    RadTanCamera,
    ThinPrismFisheyeCamera,
    decide_undistorted_camera,
)
from badslam_torch.geometry.se3 import SE3
from badslam_torch.io import native_loader
from badslam_torch.io.png import read_png

_log = logging.getLogger("badslam_torch")


_decoder_logged = False


def _read_png(path: str) -> np.ndarray:
    """Decode with libpng through the native loader where it loads, else
    with io/png.py (as the JAX package falls back to cv2); logs once which
    decoder serves."""
    global _decoder_logged
    if not _decoder_logged:
        _decoder_logged = True
        _log.info("PNG decoder: %s", native_loader.decoder_name())
    if native_loader.available():
        img = native_loader.read_png(path)
        if img is not None:
            return img
    return read_png(path)


def _imread_depth(path: str) -> np.ndarray:
    img = _read_png(path)
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.uint16)


def _imread_color(path: str) -> np.ndarray:
    img = _read_png(path)
    if img.ndim == 3 and img.shape[2] == 2:  # gray + alpha
        img = img[..., 0]
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    return np.ascontiguousarray(img[..., :3])


@dataclass
class RGBDVideo:
    """Lazy-loading RGB-D sequence + camera + per-frame poses."""

    base_path: str
    color_paths: List[str]
    depth_paths: List[str]
    timestamps: List[float]
    camera: PinholeCamera
    # global_T_frame per frame: the dataset prior where a trajectory was
    # given, None until tracked otherwise.
    poses: List[Optional[SE3]] = field(default_factory=list)
    # [H, W, 2] f32 source-pixel remap when the source images are distorted
    # (built by the loader, applied by preprocess_frame); None for pinhole.
    undistortion_map: Optional[np.ndarray] = None
    _color_cache: Dict[int, np.ndarray] = field(default_factory=dict)
    _depth_cache: Dict[int, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        if not self.poses:
            self.poses = [None] * len(self.color_paths)

    def __len__(self) -> int:
        return len(self.color_paths)

    def depth_u16(self, index: int) -> np.ndarray:
        if index not in self._depth_cache:
            self._depth_cache[index] = _imread_depth(self.depth_paths[index])
        return self._depth_cache[index]

    def color_u8(self, index: int) -> np.ndarray:
        if index not in self._color_cache:
            self._color_cache[index] = _imread_color(self.color_paths[index])
        return self._color_cache[index]

    def clear_frame(self, index: int) -> None:
        self._color_cache.pop(index, None)
        self._depth_cache.pop(index, None)

    def set_pose(self, index: int, pose: SE3) -> None:
        self.poses[index] = pose


def load_tum_trajectory(path: str) -> Tuple[List[float], List[SE3]]:
    """TUM trajectory file: ts tx ty tz qx qy qz qw (global_T_frame)."""
    timestamps, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tx, ty, tz, qx, qy, qz, qw = (float(v) for v in parts[1:8])
            timestamps.append(float(parts[0]))
            poses.append(SE3(np.array([qw, qx, qy, qz], np.float32),
                             np.array([tx, ty, tz], np.float32)))
    return timestamps, poses


def _slerp(qa: np.ndarray, qb: np.ndarray, f: float) -> np.ndarray:
    """Quaternion slerp in float64 (Eigen Quaternion::slerp semantics)."""
    qa = np.asarray(qa, float)
    qb = np.asarray(qb, float)
    d = float(qa @ qb)
    if d < 0:
        qb = -qb
        d = -d
    if d > 0.9995:
        out = (1 - f) * qa + f * qb
        return out / np.linalg.norm(out)
    theta = np.arccos(min(1.0, d))
    return (np.sin((1 - f) * theta) * qa + np.sin(f * theta) * qb) / np.sin(theta)


def _interpolate_trajectory(ts: List[float], poses: List[SE3],
                            timestamps: List[float]) -> List[SE3]:
    """Trajectory at each frame timestamp: translation lerp + quaternion
    slerp between the bracketing poses, clamped at the ends, after sorting
    the trajectory by timestamp (float64 throughout)."""
    order = np.argsort(np.array(ts, np.float64), kind="stable")
    ts_arr = np.array(ts, np.float64)[order]
    qs = [np.asarray(poses[k].q, np.float64) for k in order]
    tvs = [np.asarray(poses[k].t, np.float64) for k in order]
    out = []
    for t in timestamps:
        j = int(np.searchsorted(ts_arr, t))
        if j <= 0:
            q, tv = qs[0], tvs[0]
        elif j >= len(qs):
            q, tv = qs[-1], tvs[-1]
        else:
            denom = max(ts_arr[j] - ts_arr[j - 1], 1e-12)
            f = float((t - ts_arr[j - 1]) / denom)
            q = _slerp(qs[j - 1], qs[j], f)
            tv = (1.0 - f) * tvs[j - 1] + f * tvs[j]
        out.append(SE3(np.asarray(q, np.float32), np.asarray(tv, np.float32)))
    return out


def _read_tum_file_list(path: str) -> List[Tuple[float, str]]:
    """One TUM rgb.txt/depth.txt: 'timestamp filename' per line."""
    out: List[Tuple[float, str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def associate_frames(
    rgb: List[Tuple[float, str]],
    depth: List[Tuple[float, str]],
    max_difference: float = 0.02,
) -> List[Tuple[float, str, float, str]]:
    """Match the rgb and depth streams of a raw TUM download by timestamp:
    each rgb frame takes its nearest depth frame within `max_difference`
    seconds (associate.py's default), each depth frame is used at most
    once, and ties go to the earlier candidate (a sorted two-pointer sweep)."""
    rgb = sorted(rgb)
    depth = sorted(depth)
    out: List[Tuple[float, str, float, str]] = []
    j = 0           # first depth frame with timestamp >= current rgb ts
    last_used = -1  # each depth frame pairs at most once
    for ts, fname in rgb:
        while j < len(depth) and depth[j][0] < ts:
            j += 1
        best = None
        for k in (j - 1, j):  # the two straddling candidates
            if last_used < k < len(depth):
                dt = abs(depth[k][0] - ts)
                if dt <= max_difference and (best is None or dt < best[0]):
                    best = (dt, k)
        if best is not None:
            k = best[1]
            out.append((ts, fname, depth[k][0], depth[k][1]))
            last_used = k
    return out


def _source_camera(model_name: Optional[str], pinhole: PinholeCamera,
                  distortion: List[float]):
    """The distorted source model of a calibration line, or None when the
    images are pinhole (a radial-tangential model with all terms zero is
    one); an unknown model name raises ValueError."""
    if model_name in ("radtan", "radtan8", "radtan9"):
        if not any(abs(v) > 0 for v in distortion):
            return None
        k = (distortion + [0.0] * 4)[:4]
        return RadTanCamera(pinhole=pinhole, k1=k[0], k2=k[1], p1=k[2], p2=k[3])
    if model_name in ("thin_prism_fisheye", "fisheye"):
        k = (distortion + [0.0] * 8)[:8]
        return ThinPrismFisheyeCamera(
            pinhole=pinhole, k1=k[0], k2=k[1], k3=k[2], k4=k[3],
            p1=k[4], p2=k[5], sx1=k[6], sy1=k[7])
    if model_name not in (None, "pinhole"):
        raise ValueError(f"unknown camera model '{model_name}'")
    return None


def load_tum_dataset(path: str, trajectory_filename: Optional[str] = None) -> RGBDVideo:
    with open(os.path.join(path, "calibration.txt")) as f:
        tokens = f.readline().split()
    # Calibration grammar: [model_name] fx fy cx cy [distortion...], the
    # model inferred from the parameter count when unnamed: 4 -> pinhole;
    # 6/8 -> radtan (k1 k2 [p1 p2]); 12 -> thin-prism fisheye
    # (k1 k2 k3 k4 p1 p2 sx1 sy1).
    model_name = None
    if tokens and not tokens[0].lstrip("+-").replace(".", "", 1).isdigit():
        model_name = tokens.pop(0).lower()
    calib_vals = [float(v) for v in tokens]
    fx, fy, cx, cy = calib_vals[:4]
    distortion = calib_vals[4:]
    if model_name is None:
        model_name = {0: "pinhole", 2: "radtan", 4: "radtan",
                      8: "thin_prism_fisheye"}.get(len(distortion))
        if model_name is None:
            raise ValueError(f"calibration.txt: cannot infer camera model from "
                             f"{4 + len(distortion)} parameters")

    color_paths: List[str] = []
    depth_paths: List[str] = []
    timestamps: List[float] = []
    assoc_path = os.path.join(path, "associated.txt")
    if os.path.exists(assoc_path):
        with open(assoc_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rgb_ts, rgb_file, _, depth_file = line.split()[:4]
                color_paths.append(os.path.join(path, rgb_file))
                depth_paths.append(os.path.join(path, depth_file))
                timestamps.append(float(rgb_ts))
    elif os.path.exists(os.path.join(path, "rgb.txt")) and os.path.exists(
            os.path.join(path, "depth.txt")):
        # A raw TUM download (associate.py not run): associate in the loader.
        pairs = associate_frames(
            _read_tum_file_list(os.path.join(path, "rgb.txt")),
            _read_tum_file_list(os.path.join(path, "depth.txt")))
        for rgb_ts, rgb_file, _, depth_file in pairs:
            color_paths.append(os.path.join(path, rgb_file))
            depth_paths.append(os.path.join(path, depth_file))
            timestamps.append(rgb_ts)
    else:
        raise FileNotFoundError(
            f"{assoc_path} (and no rgb.txt/depth.txt to associate)")
    if not color_paths:
        raise ValueError(f"empty associated.txt in {path}")

    first = _imread_depth(depth_paths[0])
    h, w = first.shape
    camera = PinholeCamera(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h)
    # A distorted source: SLAM runs on the pinhole covering its field of
    # view (DecideForUndistortedCamera without avoid_invalid_pixels, the
    # depth camera's choice, input_structure.cc:414); preprocessing remaps
    # each frame through the map built here.
    src = _source_camera(model_name, camera, distortion)
    if src is not None:
        camera = decide_undistorted_camera(src, avoid_invalid_pixels=False)

    frame_poses: List[Optional[SE3]] = [None] * len(timestamps)
    if trajectory_filename:
        ts, poses = load_tum_trajectory(os.path.join(path, trajectory_filename))
        frame_poses = _interpolate_trajectory(ts, poses, timestamps)

    video = RGBDVideo(base_path=path, color_paths=color_paths,
                      depth_paths=depth_paths, timestamps=timestamps,
                      camera=camera, poses=frame_poses)
    video._depth_cache[0] = first
    if src is not None:
        video.undistortion_map = src.undistortion_map(camera)
    return video


def save_tum_trajectory(path: str, timestamps, poses) -> None:
    """Write poses in TUM format ("ts tx ty tz qx qy qz qw"); None skipped."""
    with open(path, "w") as f:
        for ts, pose in zip(timestamps, poses):
            if pose is None:
                continue
            q = np.asarray(pose.q, np.float64)
            t = np.asarray(pose.t, np.float64)
            f.write(
                f"{ts} {t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n"
            )
