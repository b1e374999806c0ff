"""Synthetic analytic scenes and datasets (numpy only).

Counterpart of the parts of ``badslam_tpu/synthetic.py`` that the port's
slices need: a few analytic planes ray-cast into depth and intensity maps
along a smooth ground-truth trajectory, through a pinhole or a
radial-tangential (distorted) camera, written as a TUM-format dataset
through ``io.png`` (associated, or as a raw download's rgb.txt/depth.txt),
and the ATE metric. Poses are host ``se3.SE3`` pairs of
numpy float32 arrays (q wxyz, t).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence, Tuple

import numpy as np

from badslam_torch.geometry.camera import PinholeCamera, RadTanCamera
from badslam_torch.geometry.se3 import SE3
from badslam_torch.io.png import write_png


class PlaneScene(NamedTuple):
    points: np.ndarray   # [P, 3] a point on each plane (world frame)
    normals: np.ndarray  # [P, 3] unit normals


def default_camera(width: int = 320, height: int = 240) -> PinholeCamera:
    # fx/fy chosen VGA-like, corner-convention principal point at center.
    f = 0.55 * width
    return PinholeCamera(fx=f, fy=f, cx=width / 2.0, cy=height / 2.0,
                         width=width, height=height)


def random_plane_scene(rng: np.random.Generator, num_planes: int = 3) -> PlaneScene:
    """Planes roughly facing the camera at ~2 m depth."""
    points = np.stack(
        [
            rng.uniform(-0.5, 0.5, num_planes),
            rng.uniform(-0.5, 0.5, num_planes),
            rng.uniform(1.7, 2.3, num_planes),
        ],
        axis=-1,
    )
    normals = rng.normal(size=(num_planes, 3))
    normals[:, 2] = -np.abs(normals[:, 2]) - 1.5  # face the camera
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return PlaneScene(points.astype(np.float32), normals.astype(np.float32))


def intensity_at(points: np.ndarray) -> np.ndarray:
    """Smooth, locally-varying world-space albedo in [0, 1], u8-quantized."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    v = (
        0.5
        + 0.17 * np.sin(9.0 * x + 3.0 * z)
        + 0.17 * np.cos(8.0 * y - 2.0 * x)
        + 0.12 * np.sin(6.0 * (x + y + z))
    )
    v = np.clip(v, 0.0, 1.0)
    return np.floor(v * 255.0 + 0.5) / 255.0


def _quat_to_matrix(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def render_scene(cam: PinholeCamera, scene: PlaneScene,
                 world_T_frame: SE3) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast the plane scene. Returns (depth [H,W] f32, intensity [H,W] f32).

    Depth is the z-depth of the nearest plane intersection in front of the
    camera; pixels hitting no plane get 0."""
    ys, xs = np.mgrid[0:cam.height, 0:cam.width]
    dx = cam.fx_inv * xs + cam.cx_inv
    dy = cam.fy_inv * ys + cam.cy_inv
    return _render_from_dirs(dx, dy, scene, world_T_frame)


def render_scene_radtan(rtcam: RadTanCamera, scene: PlaneScene, world_T_frame: SE3,
                        iterations: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast through a radial-tangential (distorted) camera: per source
    pixel the undistorted normalized direction comes from a fixed-point
    inversion of the Brown model, then the plane ray-cast runs."""
    cam = rtcam.pinhole
    ys, xs = np.mgrid[0:cam.height, 0:cam.width]
    xd = (xs + 0.5 - cam.cx) / cam.fx
    yd = (ys + 0.5 - cam.cy) / cam.fy
    nx, ny = xd.copy(), yd.copy()
    for _ in range(iterations):
        radial, tx, ty = rtcam.radial_and_tangential(nx, ny)
        nx = (xd - tx) / radial
        ny = (yd - ty) / radial
    return _render_from_dirs(nx, ny, scene, world_T_frame)


def _render_from_dirs(dx, dy, scene: PlaneScene, world_T_frame: SE3):
    """Plane-scene ray-cast along per-pixel directions (dx, dy, 1)."""
    q = np.asarray(world_T_frame.q, np.float64)
    t = np.asarray(world_T_frame.t, np.float64)
    R_wf = _quat_to_matrix(q)
    q_fw = np.array([q[0], -q[1], -q[2], -q[3]])
    R_fw = _quat_to_matrix(q_fw)
    t_fw = -(R_wf.T @ t)

    # Plane into camera frame: n_c = R n_w; p_c = R p_w + t
    n_c = scene.normals @ R_fw.T
    p_c = scene.points @ R_fw.T + t_fw

    height, width = dx.shape
    # Ray direction (dx, dy, 1); z-depth d solves n.(d*dir - p) = 0.
    best = np.full((height, width), np.inf, np.float32)
    for i in range(len(scene.points)):
        denom = n_c[i, 0] * dx + n_c[i, 1] * dy + n_c[i, 2]
        num = n_c[i] @ p_c[i]
        with np.errstate(divide="ignore", invalid="ignore"):
            d = num / denom
        d = np.where((np.abs(denom) > 1e-9) & (d > 0.05), d, np.inf)
        best = np.minimum(best, d.astype(np.float32))

    depth = np.where(np.isfinite(best), best, 0.0).astype(np.float32)

    # Intensity from the world-space position of the hit point.
    pts_cam = np.stack([depth * dx, depth * dy, depth], axis=-1)
    pts_world = pts_cam @ R_wf.T + t
    inten = intensity_at(pts_world).astype(np.float32)
    inten = np.where(depth > 0, inten, 0.0)
    return depth, inten


def pose(tx=0.0, ty=0.0, tz=0.0, rx=0.0, ry=0.0, rz=0.0) -> SE3:
    """SE3 (numpy float32) from a twist [v, w], by Rodrigues in float64."""
    v = np.array([tx, ty, tz], np.float64)
    w = np.array([rx, ry, rz], np.float64)
    theta = float(np.linalg.norm(w))
    if theta < 1e-12:
        q = np.array([1.0, 0.0, 0.0, 0.0])
        t = v
    else:
        axis = w / theta
        half = theta / 2.0
        q = np.concatenate([[np.cos(half)], np.sin(half) * axis])
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        K /= theta
        V = (np.eye(3) + (1 - np.cos(theta)) / theta * K
             + (theta - np.sin(theta)) / theta * (K @ K))
        t = V @ v
    return SE3(q.astype(np.float32), np.asarray(t, np.float32))


def smooth_trajectory(num_frames: int, scale: float = 0.004):
    """Ground-truth poses along a smooth arc (world_T_frame per frame)."""
    poses = []
    for i in range(num_frames):
        s = i * scale
        poses.append(
            pose(tx=3.0 * s, ty=0.8 * np.sin(0.15 * i) * s, tz=-1.2 * s,
                 ry=2.0 * s, rz=0.5 * s)
        )
    return poses


def write_tum_dataset(
    path: str,
    cam: PinholeCamera,
    scene: PlaneScene,
    poses: Sequence[SE3],
    raw_to_float_depth: float = 1.0 / 5000.0,
    write_gt: bool = True,
    distortion=None,
) -> None:
    """Write a synthetic TUM-format dataset directory: calibration.txt,
    associated.txt, gray RGB and 16-bit depth PNGs, optional groundtruth.txt.
    With `distortion` ((k1, k2[, p1, p2])) the images are rendered through
    the radial-tangential model and calibration.txt carries the line
    "fx fy cx cy k1 k2 p1 p2"."""
    rtcam = None
    if distortion is not None:
        k = list(distortion) + [0.0] * (4 - len(distortion))
        rtcam = RadTanCamera(pinhole=cam, k1=k[0], k2=k[1], p1=k[2], p2=k[3])
    os.makedirs(os.path.join(path, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(path, "depth"), exist_ok=True)
    with open(os.path.join(path, "calibration.txt"), "w") as f:
        line = f"{cam.fx} {cam.fy} {cam.cx} {cam.cy}"
        if rtcam is not None:
            line += f" {rtcam.k1} {rtcam.k2} {rtcam.p1} {rtcam.p2}"
        f.write(line + "\n")

    assoc_lines = []
    gt_lines = []
    for i, world_T_frame in enumerate(poses):
        if rtcam is not None:
            depth, inten = render_scene_radtan(rtcam, scene, world_T_frame)
        else:
            depth, inten = render_scene(cam, scene, world_T_frame)
        depth_u16 = np.clip(depth / raw_to_float_depth, 0, 65535).astype(np.uint16)
        gray = np.clip(inten * 255.0 + 0.5, 0, 255).astype(np.uint8)
        rgb = np.stack([gray, gray, gray], axis=-1)
        ts = f"{i / 30.0:.6f}"
        rgb_rel = f"rgb/{i:05d}.png"
        depth_rel = f"depth/{i:05d}.png"
        write_png(os.path.join(path, rgb_rel), rgb)
        write_png(os.path.join(path, depth_rel), depth_u16)
        assoc_lines.append(f"{ts} {rgb_rel} {ts} {depth_rel}")
        q = np.asarray(world_T_frame.q, np.float64)
        t = np.asarray(world_T_frame.t, np.float64)
        gt_lines.append(f"{ts} {t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]}")

    with open(os.path.join(path, "associated.txt"), "w") as f:
        f.write("\n".join(assoc_lines) + "\n")
    if write_gt:
        with open(os.path.join(path, "groundtruth.txt"), "w") as f:
            f.write("\n".join(gt_lines) + "\n")


def make_raw_tum_lists(path: str, depth_offset_s: float = 0.0,
                       drop_depth: Sequence[int] = ()) -> None:
    """Turn a dataset written by `write_tum_dataset` into the layout of a raw
    TUM download: rgb.txt and depth.txt instead of associated.txt, the depth
    stamps offset by `depth_offset_s` seconds and the depth frames at the
    indices `drop_depth` left out (the loader then associates the streams)."""
    assoc = os.path.join(path, "associated.txt")
    with open(assoc) as f:
        rows = [line.split() for line in f if line.strip()]
    with open(os.path.join(path, "rgb.txt"), "w") as f:
        f.write("# timestamp filename\n")
        f.writelines(f"{r[0]} {r[1]}\n" for r in rows)
    with open(os.path.join(path, "depth.txt"), "w") as f:
        f.write("# timestamp filename\n")
        f.writelines(f"{float(r[2]) + depth_offset_s:.6f} {r[3]}\n"
                     for i, r in enumerate(rows) if i not in set(drop_depth))
    os.remove(assoc)


def ate_rmse(est_poses, gt_poses) -> float:
    """ATE RMSE of the translations after rigid (Horn) alignment."""
    est = np.array([np.asarray(p.t, np.float64) for p in est_poses])
    gt = np.array([np.asarray(p.t, np.float64) for p in gt_poses])
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, _, Vt = np.linalg.svd(E.T @ G)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ S @ Vt).T
    aligned = est @ R.T + (mu_g - R @ mu_e)
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))
