"""Synthetic analytic scenes and datasets (numpy; torch for the device ATE).

Counterpart of ``badslam_tpu/synthetic.py``: a few analytic planes
ray-cast into depth and intensity maps along a smooth ground-truth
trajectory, through a pinhole or a radial-tangential (distorted) camera,
written as a TUM-format dataset through ``io.png`` (associated, or as a raw
download's rgb.txt/depth.txt); the loop-closure fixture: a textured box
room, a revisiting circular trajectory, and sensor noise and depth bias in
the written dataset; the random heightmap mesh and its rasterizer (the
tracker's non-planar test scene); the ATE metric with SE3, Sim3 or no
alignment, and its device form on a trajectory tensor. Poses are host
``se3.SE3`` pairs of numpy float32 arrays (q wxyz, t).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from badslam_torch.geometry import se3_np as s3
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


def textured_intensity_at(points: np.ndarray, cell: float = 0.05,
                          seed: int = 0) -> np.ndarray:
    """Blocky world-space albedo: constant within `cell`-sized 3D cells,
    discontinuous across them (corner-rich, so FAST finds features), from
    a deterministic integer hash per cell; u8-quantized."""
    c = np.floor(points / cell).astype(np.int64)
    h = (c[..., 0] * 73856093) ^ (c[..., 1] * 19349663) \
        ^ (c[..., 2] * 83492791) ^ (np.int64(seed) * 2654435761)
    v = ((h ^ (h >> 13)) & 0xFFFF).astype(np.float64) / 65535.0
    v = 0.15 + 0.7 * v
    return np.floor(v * 255.0 + 0.5) / 255.0


def room_scene(size: float = 3.0) -> PlaneScene:
    """Box room: 6 inward-facing planes centered at the origin (the fixture
    for in-place loop trajectories)."""
    half = size / 2.0
    pts = np.array([[half, 0, 0], [-half, 0, 0], [0, half, 0], [0, -half, 0],
                    [0, 0, half], [0, 0, -half]], np.float32)
    normals = -pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    return PlaneScene(pts, normals.astype(np.float32))


def loop_trajectory(num_frames: int, loop_frames: Optional[int] = None,
                    orbit_radius: float = 0.8, height_wobble: float = 0.03) -> list:
    """A revisiting walk: the camera travels a circle of `orbit_radius`
    facing along the tangent, closes the loop in `loop_frames` frames and
    keeps going, so frames past `loop_frames` see the start sector again
    with all the drift the odometry accumulated."""
    if loop_frames is None:
        loop_frames = max(1, int(num_frames * 0.9))
    poses = []
    for i in range(num_frames):
        th = 2.0 * np.pi * i / loop_frames
        p = pose(ry=th + np.pi / 2.0)  # camera +z along the tangent
        t = np.array([orbit_radius * np.sin(th), height_wobble * np.sin(3.0 * th),
                      orbit_radius * (np.cos(th) - 1.0)], np.float32)
        poses.append(SE3(p.q, t))
    return poses


def _quat_to_matrix(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def render_scene(cam: PinholeCamera, scene: PlaneScene, world_T_frame: SE3,
                 albedo=None) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast the plane scene. Returns (depth [H,W] f32, intensity [H,W] f32).

    Depth is the z-depth of the nearest plane intersection in front of the
    camera; pixels hitting no plane get 0. `albedo(points_world)` replaces
    the smooth default intensity (e.g. textured_intensity_at)."""
    ys, xs = np.mgrid[0:cam.height, 0:cam.width]
    dx = cam.fx_inv * xs + cam.cx_inv
    dy = cam.fy_inv * ys + cam.cy_inv
    return _render_from_dirs(dx, dy, scene, world_T_frame, albedo)


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


def _render_from_dirs(dx, dy, scene: PlaneScene, world_T_frame: SE3, albedo=None):
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
    inten = (albedo or intensity_at)(pts_world).astype(np.float32)
    inten = np.where(depth > 0, inten, 0.0)
    return depth, inten


class HeightmapMesh(NamedTuple):
    """Random-heightmap triangle mesh fixture (the reference's heaviest
    tracker test scene, test_pairwise_frame_tracking.cc:280-340)."""

    vertices: np.ndarray   # [V, 3] world-space positions
    faces: np.ndarray      # [F, 3] int32 vertex indices
    colors: np.ndarray     # [V] f32 per-vertex intensity in [0, 1]


def heightmap_mesh_scene(
    rng: np.random.Generator,
    vertices_x: int = 31,
    vertices_y: int = 31,
    extent: float = 5.0,
    z_distance: float = 1.0,
    z_variation: float = 0.05,
) -> HeightmapMesh:
    """Random heightmap at z~1 with +-z_variation noise, borders pulled back
    to avoid self-occlusion, random per-vertex colors: the reference's
    fixture parameters (test_pairwise_frame_tracking.cc:292-340), drawn from
    `rng` in the JAX package's order."""
    xs = np.linspace(-0.5, 0.5, vertices_x)
    ys = np.linspace(-0.5, 0.5, vertices_y)
    gx, gy = np.meshgrid(xs, ys)
    z = z_distance + rng.uniform(-z_variation, z_variation, gx.shape)
    z -= 6.0 * np.sqrt(gx * gx + gy * gy)  # pull back borders
    vertices = np.stack([gx * extent, gy * extent, z], axis=-1).reshape(-1, 3)
    colors = rng.integers(0, 256, len(vertices)).astype(np.float32) / 255.0

    faces = []
    for y in range(vertices_y - 1):
        for x in range(vertices_x - 1):
            i00 = x + y * vertices_x
            i10 = (x + 1) + y * vertices_x
            i01 = x + (y + 1) * vertices_x
            i11 = (x + 1) + (y + 1) * vertices_x
            faces.append((i01, i10, i00))
            faces.append((i01, i11, i10))
    return HeightmapMesh(vertices.astype(np.float32), np.array(faces, np.int32), colors)


def render_mesh(cam: PinholeCamera, mesh: HeightmapMesh, world_T_frame: SE3,
                min_depth: float = 0.1,
                max_depth: float = 20.0) -> Tuple[np.ndarray, np.ndarray]:
    """Z-buffer rasterization of the mesh (host numpy; the reference renders
    with offscreen OpenGL): perspective-correct barycentric interpolation of
    depth and vertex intensity. Returns (depth [H,W] f32 z-depth, intensity
    [H,W] f32)."""
    q = np.asarray(world_T_frame.q, np.float64)
    t = np.asarray(world_T_frame.t, np.float64)
    R = _quat_to_matrix(np.array([q[0], -q[1], -q[2], -q[3]]))
    vc = mesh.vertices @ R.T + -(_quat_to_matrix(q).T @ t)  # camera-frame vertices

    h, w = cam.height, cam.width
    depth_buf = np.full((h, w), np.inf, np.float64)
    inten_buf = np.zeros((h, w), np.float64)

    z = vc[:, 2]
    px = cam.fx * vc[:, 0] / np.where(z > 0, z, 1.0) + cam.cx
    py = cam.fy * vc[:, 1] / np.where(z > 0, z, 1.0) + cam.cy

    for f in mesh.faces:
        if np.any(vc[f, 2] <= min_depth):
            continue
        tx, ty = px[f], py[f]
        x0 = max(int(np.floor(tx.min())), 0)
        x1 = min(int(np.ceil(tx.max())), w - 1)
        y0 = max(int(np.floor(ty.min())), 0)
        y1 = min(int(np.ceil(ty.max())), h - 1)
        if x1 < x0 or y1 < y0:
            continue
        gy, gx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
        # Pixel centers in corner convention.
        pxc = gx + 0.5
        pyc = gy + 0.5
        d = ((ty[1] - ty[2]) * (tx[0] - tx[2])
             + (tx[2] - tx[1]) * (ty[0] - ty[2]))
        if abs(d) < 1e-12:
            continue
        b0 = ((ty[1] - ty[2]) * (pxc - tx[2])
              + (tx[2] - tx[1]) * (pyc - ty[2])) / d
        b1 = ((ty[2] - ty[0]) * (pxc - tx[2])
              + (tx[0] - tx[2]) * (pyc - ty[2])) / d
        b2 = 1.0 - b0 - b1
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        if not inside.any():
            continue
        inv_z = (b0 / vc[f[0], 2] + b1 / vc[f[1], 2] + b2 / vc[f[2], 2])
        zi = 1.0 / np.maximum(inv_z, 1e-12)
        ci = (b0 * mesh.colors[f[0]] / vc[f[0], 2]
              + b1 * mesh.colors[f[1]] / vc[f[1], 2]
              + b2 * mesh.colors[f[2]] / vc[f[2], 2]) * zi
        win_d = depth_buf[y0:y1 + 1, x0:x1 + 1]
        win_i = inten_buf[y0:y1 + 1, x0:x1 + 1]
        closer = inside & (zi < win_d)
        win_d[closer] = zi[closer]
        win_i[closer] = ci[closer]

    depth = np.where(np.isfinite(depth_buf) & (depth_buf <= max_depth),
                     depth_buf, 0.0).astype(np.float32)
    inten = np.floor(np.clip(inten_buf, 0, 1) * 255.0 + 0.5) / 255.0
    return depth, np.where(depth > 0, inten, 0.0).astype(np.float32)


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
    albedo=None,
    depth_noise: float = 0.0,
    depth_bias: float = 0.0,
    depth_bias_quadratic: float = 0.0,
    intensity_noise: float = 0.0,
    noise_seed: int = 0,
) -> None:
    """Write a synthetic TUM-format dataset directory: calibration.txt,
    associated.txt, gray RGB and 16-bit depth PNGs, optional groundtruth.txt.
    With `distortion` ((k1, k2[, p1, p2])) the images are rendered through
    the radial-tangential model and calibration.txt carries the line
    "fx fy cx cy k1 k2 p1 p2". `albedo` replaces the intensity function
    (pinhole only). Sensor effects, drawn from default_rng(noise_seed) in the
    JAX package's order: depth scaled by (1 + depth_bias +
    depth_bias_quadratic * d), depth noise of sigma depth_noise * d^2, and
    gray-level noise of sigma intensity_noise (u8 scale)."""
    noise_rng = np.random.default_rng(noise_seed)
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
            depth, inten = render_scene(cam, scene, world_T_frame, albedo)
        if depth_bias != 0.0 or depth_bias_quadratic != 0.0:
            depth = depth * (1.0 + depth_bias + depth_bias_quadratic * depth)
        if depth_noise > 0:
            sigma = depth_noise * depth * depth
            depth = np.where(
                depth > 0,
                np.maximum(depth + sigma * noise_rng.standard_normal(depth.shape), 1e-3),
                0.0).astype(np.float32)
        depth_u16 = np.clip(depth / raw_to_float_depth, 0, 65535).astype(np.uint16)
        if intensity_noise > 0:
            inten = inten + (intensity_noise / 255.0) * noise_rng.standard_normal(inten.shape)
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


def align_trajectory(est: np.ndarray, gt: np.ndarray, align: str = "se3"):
    """Positions est [N, 3] aligned onto gt [N, 3] (Horn / Umeyama): "se3"
    (rigid), "sim3" (rigid + scale, the TUM benchmark's scale-invariant
    variant) or "none". Returns (aligned positions, scale)."""
    if align == "none":
        return est, 1.0
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, sv, Vt = np.linalg.svd(E.T @ G)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ S @ Vt).T
    if align == "sim3":
        # Umeyama: c = tr(diag(sv) S) / sum ||E_i||^2.
        scale = float(np.sum(sv * np.diag(S)) / max(np.sum(E * E), 1e-30))
    else:
        scale = 1.0
    return scale * (est @ R.T) + (mu_g - scale * (R @ mu_e)), scale


def ate_rmse(est_poses, gt_poses, align: str = "se3") -> float:
    """ATE RMSE of the translations after `align_trajectory` (the ETH3D
    benchmark metric with "se3")."""
    est = np.array([np.asarray(p.t, np.float64) for p in est_poses])
    gt = np.array([np.asarray(p.t, np.float64) for p in gt_poses])
    aligned, _ = align_trajectory(est, gt, align)
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))


def _centred(traj_t: torch.Tensor, gt_t):
    """The trajectory [F, 3] and ground truth (array or tensor) as float64
    on traj_t's device, each minus its mean."""
    est = traj_t.to(torch.float64)
    gt = torch.as_tensor(gt_t, dtype=torch.float64, device=est.device)
    return est - est.mean(0), gt - gt.mean(0)


def ate_moments_device(traj_t: torch.Tensor, gt_t):
    """The device half of the SE3-aligned ATE: the centred trajectory E and
    ground truth G ([F, 3], float64 on traj_t's device) reduced to the
    Horn / Umeyama sufficient statistics, C = E^T G [3, 3], sum |E|^2 and
    sum |G|^2, all three from one product of [E G] with itself. Returns
    device tensors; nothing is read back."""
    x = torch.cat(_centred(traj_t, gt_t), dim=1)
    m = x.T @ x
    return m[:3, 3:], torch.trace(m[:3, :3]), torch.trace(m[3:, 3:])


def ate_rmse_from_moments(C, se, sg, n: int) -> float:
    """The host half: the closed-form minimum of the aligned residual,
    min_R sum |R E_i - G_i|^2 = se + sg - 2 (s1 + s2 + sign(det(U V^T)) s3)
    with C = U diag(s) V^T (Kabsch). Matches ate_rmse(align="se3") up to
    the cancellation of that difference."""
    C = np.asarray(torch.as_tensor(C).cpu(), np.float64)
    U, sv, Vt = np.linalg.svd(C)
    s = np.sign(np.linalg.det(U @ Vt))
    resid = max(float(se) + float(sg) - 2.0 * (sv[0] + sv[1] + s * sv[2]), 0.0)
    return float(np.sqrt(resid / n))


def ate_rmse_device(traj_t: torch.Tensor, gt_t) -> torch.Tensor:
    """The SE3-aligned ATE RMSE on traj_t's device as one 0-d float64
    tensor, with no read back and no SVD: Horn's closed-form absolute
    orientation (the optimal rotation's quaternion is the dominant
    eigenvector of the 4x4 symmetric K(S), S = E^T G), found by 30 shifted
    matrix squarings, and the residual summed directly, sum |E_i R^T -
    G_i|^2 (not Horn's se + sg - 2 lambda, which cancels). Both rotation
    conventions are evaluated and the smaller residual kept: the other is
    never smaller, so the result is the optimum. In float64 it matches
    ate_rmse(align="se3") to ~1e-12 relative."""
    E, G = _centred(traj_t, gt_t)
    n = E.shape[0]
    S = E.T @ G
    t = torch.trace(S)
    K = torch.stack([
        torch.stack([t, S[1, 2] - S[2, 1], S[2, 0] - S[0, 2], S[0, 1] - S[1, 0]]),
        torch.stack([S[1, 2] - S[2, 1], 2 * S[0, 0] - t, S[0, 1] + S[1, 0], S[2, 0] + S[0, 2]]),
        torch.stack([S[2, 0] - S[0, 2], S[0, 1] + S[1, 0], 2 * S[1, 1] - t, S[1, 2] + S[2, 1]]),
        torch.stack([S[0, 1] - S[1, 0], S[2, 0] + S[0, 2], S[1, 2] + S[2, 1], 2 * S[2, 2] - t]),
    ])
    # Shift to make lambda_max(K) the dominant eigenvalue of a PSD matrix
    # (Gershgorin), then square 30 times, renormalizing by max |B|.
    B = K + (1.0 + K.abs().sum()) * torch.eye(4, dtype=K.dtype, device=K.device)
    B = B / B.abs().max()
    for _ in range(30):
        B = B @ B
        B = B / B.abs().max()
    q = B[:, torch.argmax((B * B).sum(dim=0))]
    q = q / torch.linalg.vector_norm(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])
    r1 = ((E @ R.T - G) ** 2).sum()
    r2 = ((E @ R - G) ** 2).sum()
    return torch.sqrt(torch.minimum(r1, r2) / n)


def tracking_pair(cam: PinholeCamera, seed: int, device, num_scales: int = 5,
                  gradmag: bool = False):
    """Two views of a random six-plane scene through `cam` (the identity and
    a small motion), each preprocessed on `device` as a frame of the
    default configuration (u16 depth in 1/5000 m, a 3 m cutoff) and built
    into a pyramid of `num_scales` levels (of gradient magnitudes with
    `gradmag`), for the tracker: (cameras, base pyramid, tracked pyramid),
    finest first, and the motion base_T_frame as (q, t) on `device`."""
    from badslam_torch.ops.preprocess import preprocess_frame
    from badslam_torch.ops.pyramid import build_pyramid

    scene = random_plane_scene(np.random.default_rng(seed), 6)
    motion = pose(tx=0.015, ty=-0.01, tz=0.008, rx=0.003, rz=0.008)
    cells = ((cam.height - 1) // 4 + 1, (cam.width - 1) // 4 + 1)
    pyramids = []
    for p in (pose(), motion):
        depth, inten = render_scene(cam, scene, p)
        raw = np.clip(depth * 5000.0, 0, 65535).astype(np.int32)
        gray = np.clip(inten * 255.0 + 0.5, 0, 255).astype(np.uint8)
        frame = preprocess_frame(
            cam, torch.from_numpy(raw).to(device),
            torch.from_numpy(np.stack([gray] * 3, axis=-1)).to(device), max_depth=3.0,
            a=torch.zeros((), device=device), cfactor=torch.zeros(cells, device=device),
            raw_to_float_depth=1.0 / 5000.0)
        pyramids.append(build_pyramid(frame.depth, frame.nx, frame.ny, frame.intensity,
                                      num_scales, gradmag=gradmag))
    cams = tuple(cam.pyramid_level(i) for i in range(num_scales))
    q, t = (torch.from_numpy(np.asarray(x, np.float32)).to(device) for x in motion)
    return cams, pyramids[0], pyramids[1], (q, t)


class PosePassState(NamedTuple):
    """The inputs of one step of keyframe BA's pose pass (numpy float32;
    pose_pass_state)."""

    cam: PinholeCamera
    pos: np.ndarray        # [N, 3] surfel rows
    normal: np.ndarray     # [N, 3]
    radius2: np.ndarray    # [N]
    desc: np.ndarray       # [N, 2]
    valid: np.ndarray      # [N] bool
    q: np.ndarray          # [C, 4] keyframe global_T_frame (perturbed)
    t: np.ndarray          # [C, 3]
    depth: np.ndarray      # [C, H, W]
    nx: np.ndarray         # [C, H, W] camera-frame normal components
    ny: np.ndarray
    intensity: np.ndarray  # [C, H, W]


def pose_pass_state(seed: int, keyframes: int, rows: int, live_share: float = 0.1,
                    width: int = 640, height: int = 480) -> PosePassState:
    """A surfel bucket of `rows` rows, about `live_share` of them live, and
    `keyframes` keyframes on a four-plane scene, for the pose pass
    (surfel_pose_coeffs, H2). The live rows sit mostly at the front, with
    dead rows scattered among them and a few live rows beyond; they are
    points of keyframe 0's view with the planes' normals, some pushed off
    their plane (failing the depth gate) or turned away (failing the facing
    test). Dead rows hold arbitrary finite values. Each keyframe's pose is
    its rendering pose times a small perturbation."""
    rng = np.random.default_rng(seed)
    cam = default_camera(width, height)
    scene = random_plane_scene(rng, 4)
    gt = [pose(tx=0.012 * c, ty=-0.006 * c, tz=0.004 * c, rx=0.003 * c, rz=0.004 * c)
          for c in range(keyframes)]
    ys, xs = np.mgrid[0:height, 0:width]
    dx = cam.fx_inv * xs + cam.cx_inv
    dy = cam.fy_inv * ys + cam.cy_inv
    planes = {k: [] for k in ("depth", "nx", "ny", "intensity")}
    for p in gt:
        depth, inten = _render_from_dirs(dx, dy, scene, p)
        R_fw = _quat_to_matrix(p.q).T
        n_c = scene.normals @ R_fw.T
        p_c = (scene.points - p.t) @ R_fw.T
        # The plane each pixel sees: the one whose z-depth is the pixel's.
        hit = np.stack([(n_c[i] @ p_c[i]) / (n_c[i, 0] * dx + n_c[i, 1] * dy + n_c[i, 2])
                        for i in range(len(n_c))])
        idx = np.argmin(np.abs(hit - depth), axis=0)
        planes["depth"].append(depth)
        planes["nx"].append(np.where(depth > 0, n_c[idx, 0], 0.0))
        planes["ny"].append(np.where(depth > 0, n_c[idx, 1], 0.0))
        planes["intensity"].append(inten)
    planes = {k: np.stack(v).astype(np.float32) for k, v in planes.items()}
    # Holes of invalid depth: a tenth of the 8x8 cells.
    cells = rng.uniform(size=(keyframes, (height + 7) // 8, (width + 7) // 8)) < 0.1
    holes = np.repeat(np.repeat(cells, 8, 1), 8, 2)[:, :height, :width]
    planes["depth"][holes] = 0.0

    # Live surfels: keyframe 0's valid pixels, back-projected.
    n_live = max(1, int(rows * live_share))
    d0 = planes["depth"][0]
    pix = np.flatnonzero(d0 > 0)
    pick = rng.choice(pix, n_live, replace=len(pix) < n_live)
    z = d0.reshape(-1)[pick]
    cam_pts = np.stack([z * dx.reshape(-1)[pick], z * dy.reshape(-1)[pick], z], -1)
    live_pos = s3.transform_points(gt[0], cam_pts)
    n_cam = np.stack([planes["nx"][0].reshape(-1)[pick], planes["ny"][0].reshape(-1)[pick]], -1)
    n_cam = np.concatenate([n_cam, -np.sqrt(np.clip(1.0 - (n_cam ** 2).sum(-1), 0, 1))[:, None]], -1)
    live_normal = n_cam @ _quat_to_matrix(gt[0].q).T
    live_pos = live_pos + live_normal * rng.normal(0.0, 0.002, (n_live, 1))
    off = rng.uniform(size=n_live) < 0.08
    live_pos[off] += live_normal[off] * 0.3
    away = rng.uniform(size=n_live) < 0.05
    live_normal[away] *= -1.0
    live_r2 = (1.5 * z / cam.fx) ** 2

    # Row layout: a front block 10% dead, the rest of the live rows beyond.
    front = min(rows, int(0.97 * n_live / 0.9))
    slots = np.flatnonzero(rng.uniform(size=front) >= 0.1)
    rest = np.setdiff1d(np.arange(rows), slots)
    at = np.concatenate([slots, rng.choice(rest, max(0, n_live - len(slots)), replace=False)])
    at = at[:n_live]
    valid = np.zeros(rows, bool)
    valid[at] = True
    pos = rng.uniform(-3.0, 3.0, (rows, 3))
    normal = rng.normal(size=(rows, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    radius2 = rng.uniform(0.0, 1e-4, rows)
    desc = rng.normal(0.0, 8.0, (rows, 2))
    pos[at], normal[at], radius2[at] = live_pos, live_normal, live_r2

    start = [s3.mul(p, pose(*rng.uniform(-0.003, 0.003, 3), *rng.uniform(-0.002, 0.002, 3)))
             for p in gt]
    f32 = np.float32
    return PosePassState(cam, pos.astype(f32), normal.astype(f32), radius2.astype(f32),
                         desc.astype(f32), valid, np.stack([p.q for p in start]).astype(f32),
                         np.stack([p.t for p in start]).astype(f32), planes["depth"],
                         planes["nx"], planes["ny"], planes["intensity"])


def pose_pass_inputs(state: PosePassState, device):
    """The state's tensors on `device`: (SurfelMap, q, t, depth, nx, ny,
    intensity), in the order surfel_pose_coeffs takes them after the
    camera."""
    from badslam_torch.mapping.surfels import SurfelMap

    on = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    valid = on(state.valid)
    smap = SurfelMap(pos=on(state.pos), normal=on(state.normal), radius2=on(state.radius2),
                     color=torch.zeros_like(on(state.pos)), desc=on(state.desc), valid=valid,
                     active=valid.clone(), count=valid.sum())
    return (smap, on(state.q), on(state.t), on(state.depth), on(state.nx), on(state.ny),
            on(state.intensity))
