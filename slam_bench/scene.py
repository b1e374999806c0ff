"""The benchmark's traffic generator: a seeded RGB-D sequence rendered on the
device in plain torch.

One general generator serves every traffic mix. A mix is a JSON file of
parameters under ``traffic/`` (``load_mix``); nothing in it is code:

* ``scene``: fixed planes (``planes``: a point and a normal each) and/or
  ``random_planes`` (a count, the ranges of their offsets, depths and tilt,
  and the seed of their draw), infinite planes; fixed axis-aligned boxes
  (``boxes``: the least and the greatest corner each) and/or groups of
  ``random_boxes`` (each a count, the ranges of the centres and of the
  sizes, and the seed of its draw). All are ray-cast exactly (the nearest
  hit in front of the camera), and ``surface_distance`` gives a point's
  distance to the nearest of them;
* ``albedo``: blocky world-space albedo, constant within cubic cells of
  ``cell_m`` and discontinuous across them, from an integer hash of the cell
  salted by the seed, so it does not repeat and carries corners;
* ``motion``: the camera's world_T_frame over time: a start plus a
  constant velocity plus sines ([axis, amplitude, Hz, phase]) on each
  position axis, and on each rotation angle (yaw, pitch, roll) a start
  (``start_deg``), a constant rate (``rotation_rates_dps``) and sines, so
  that an orbit (sines on two position axes, a yaw rate) is data alone;
* ``sensor``: the range outside which depth reads 0, the depth bias (depth
  scaled by 1 + quadratic * d), the depth noise (sigma = noise * d^2), the gray-level noise (u8 steps), then the u16
  depth (``raw_to_float_depth`` m per step) and u8 gray as RGB.

The run's seed moves the albedo's salt and the sensor noise, and nothing
that sets the amount of work: every seed renders the same scene geometry
along the same trajectory, so each sees the same surfaces at the same
times, with other texture and other noise.
Camera conventions are the port's: z forward, x right, y down, intrinsics
in the pixel-corner convention (pixel (x, y) is centred at (x + .5, y + .5)).
"""

from __future__ import annotations

import json
import math
import os
from typing import NamedTuple

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
# Frames rendered per device batch.
_BATCH = 32
_HASH_MUL = (73856093, 19349663, 83492791)
_SALT_MUL = 2654435761


class Sequence(NamedTuple):
    """A rendered sequence on the host: u16 depth [N, H, W], u8 RGB
    [N, H, W, 3], and world_T_frame per frame (float64 q wxyz [N, 4], t
    [N, 3])."""
    depth_u16: np.ndarray
    color_u8: np.ndarray
    gt_q: np.ndarray
    gt_t: np.ndarray


def load_mix(name: str, root: str = _HERE) -> dict:
    """The traffic mix `name`: traffic/<name>.json."""
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _int64(x: int) -> int:
    """`x` wrapped to a signed 64-bit integer."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


def _rot(axis: int, angle: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] rotations by `angle` [N] (float64) about axis 0, 1 or 2."""
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    elif axis == 1:
        rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    else:
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """[N, 3, 3] rotation matrices to [N, 4] unit quaternions (wxyz), with
    w >= 0."""
    out = np.empty((len(m), 4))
    for i, r in enumerate(m):
        tr = np.trace(r)
        if tr > 0:
            s = 2.0 * math.sqrt(tr + 1.0)
            q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                 (r[1, 0] - r[0, 1]) / s]
        else:
            k = int(np.argmax(np.diag(r)))
            i1, i2 = (k + 1) % 3, (k + 2) % 3
            s = 2.0 * math.sqrt(1.0 + r[k, k] - r[i1, i1] - r[i2, i2])
            q = [0.0] * 4
            q[0] = (r[i2, i1] - r[i1, i2]) / s
            q[1 + k] = 0.25 * s
            q[1 + i1] = (r[i1, k] + r[k, i1]) / s
            q[1 + i2] = (r[i2, k] + r[k, i2]) / s
        q = np.asarray(q)
        out[i] = q if q[0] >= 0 else -q
    return out


def trajectory(mix: dict, frames: int, rate_hz: float):
    """world_T_frame of each frame as float64 (R [N, 3, 3], t [N, 3]) on the
    CPU: the mix's start, velocity and rates plus its sines."""
    m = mix["motion"]
    time_s = torch.arange(frames, dtype=torch.float64) / rate_hz
    pos = torch.tensor(m["start_m"], dtype=torch.float64)[None, :] + time_s[:, None] * \
        torch.tensor(m["velocity_mps"], dtype=torch.float64)[None, :]
    for axis, amp, freq, phase in m["position_sines"]:
        pos[:, axis] += amp * torch.sin(2 * math.pi * freq * time_s + phase)
    angles = torch.zeros(frames, 3, dtype=torch.float64)  # yaw, pitch, roll
    angles += torch.tensor(m.get("start_deg", [0.0, 0.0, 0.0]), dtype=torch.float64).deg2rad()
    angles += time_s[:, None] * torch.tensor(m.get("rotation_rates_dps", [0.0, 0.0, 0.0]),
                                             dtype=torch.float64).deg2rad()
    for axis, amp_deg, freq, phase in m["rotation_sines"]:
        angles[:, axis] += math.radians(amp_deg) * torch.sin(
            2 * math.pi * freq * time_s + phase)
    # Yaw about the world's y (down) axis, then pitch about x, then roll
    # about the optical axis.
    rot = _rot(1, angles[:, 0]) @ _rot(0, angles[:, 1]) @ _rot(2, angles[:, 2])
    return rot, pos


def planes(mix: dict):
    """The scene's planes as float64 (points [P, 3], unit normals [P, 3]):
    the fixed ones, then the random ones drawn from their seed."""
    s = mix["scene"]
    pts = [list(p) for p, _ in s.get("planes", [])]
    nrm = [list(n) for _, n in s.get("planes", [])]
    rnd = s.get("random_planes")
    if rnd:
        gen = torch.Generator().manual_seed(rnd["seed"])
        for _ in range(rnd["count"]):
            u = torch.rand(3, generator=gen, dtype=torch.float64).tolist()
            lo, hi = rnd["offset_m"]
            zlo, zhi = rnd["depth_m"]
            pts.append([lo + (hi - lo) * u[0], lo + (hi - lo) * u[1],
                        zlo + (zhi - zlo) * u[2]])
            n = torch.randn(3, generator=gen, dtype=torch.float64)
            n[2] = -abs(float(n[2])) - rnd["facing"]  # face the camera
            nrm.append((n / n.norm()).tolist())
    n = torch.tensor(nrm, dtype=torch.float64)
    return torch.tensor(pts, dtype=torch.float64), n / n.norm(dim=-1, keepdim=True)


def boxes(mix: dict):
    """The scene's boxes as float64 (least corners [B, 3], greatest corners
    [B, 3]): the fixed ones, then each group of random ones drawn from its
    seed (centres and sizes uniform in their ranges)."""
    s = mix["scene"]
    lo = [list(a) for a, _ in s.get("boxes", [])]
    hi = [list(b) for _, b in s.get("boxes", [])]
    for grp in s.get("random_boxes", []):
        gen = torch.Generator().manual_seed(grp["seed"])
        c_lo, c_hi = (torch.tensor(grp[k], dtype=torch.float64) for k in ("centre_lo", "centre_hi"))
        s_lo, s_hi = (torch.tensor(grp[k], dtype=torch.float64) for k in ("size_lo", "size_hi"))
        for _ in range(grp["count"]):
            u = torch.rand(6, generator=gen, dtype=torch.float64)
            centre = c_lo + (c_hi - c_lo) * u[:3]
            half = 0.5 * (s_lo + (s_hi - s_lo) * u[3:])
            lo.append((centre - half).tolist())
            hi.append((centre + half).tolist())
    return (torch.tensor(lo, dtype=torch.float64).reshape(-1, 3),
            torch.tensor(hi, dtype=torch.float64).reshape(-1, 3))


def surface_distance(mix: dict, points: torch.Tensor) -> torch.Tensor:
    """The distance (float64) from each world point [N, 3] to the nearest
    surface of the scene: a plane, or a box's faces."""
    x = points.to(torch.float64)
    pts, nrm = planes(mix)
    pts, nrm = pts.to(x.device), nrm.to(x.device)
    best = torch.full(x.shape[:1], float("inf"), dtype=torch.float64, device=x.device)
    if len(pts):
        best = (((x[:, None, :] - pts[None]) * nrm[None]).sum(-1)).abs().min(dim=1).values
    lo, hi = boxes(mix)
    for a, b in zip(lo.to(x.device), hi.to(x.device)):
        outside = torch.clamp_min(torch.maximum(a - x, x - b), 0.0).norm(dim=-1)
        inside = torch.minimum(x - a, b - x).min(dim=-1).values
        best = torch.minimum(best, torch.where(outside > 0, outside, inside.abs()))
    return best


def _albedo(points: torch.Tensor, cell: float, lo: float, hi: float, salt: int):
    """Blocky hashed albedo in [lo, hi], u8-quantized, at world points [..., 3]."""
    c = torch.floor(points / cell).to(torch.int64)
    h = (c[..., 0] * _HASH_MUL[0]) ^ (c[..., 1] * _HASH_MUL[1]) \
        ^ (c[..., 2] * _HASH_MUL[2]) ^ salt
    v = ((h ^ (h >> 13)) & 0xFFFF).to(torch.float32) / 65535.0
    v = lo + (hi - lo) * v
    return torch.floor(v * 255.0 + 0.5) / 255.0


def render(camera: dict, mix: dict, frames: int, rate_hz: float, seed: int,
           raw_to_float_depth: float, device) -> Sequence:
    """Render `frames` frames of the mix from `seed` on `device` (batches of
    _BATCH), returned on the host."""
    device = torch.device(device)
    w, h = camera["width"], camera["height"]
    rot64, pos64 = trajectory(mix, frames, rate_hz)
    pts64, nrm64 = planes(mix)
    pts, nrm = pts64.to(device, torch.float32), nrm64.to(device, torch.float32)
    box_lo, box_hi = (b.to(device, torch.float32) for b in boxes(mix))
    a, sensor = mix["albedo"], mix["sensor"]
    salt = _int64(seed * _SALT_MUL)
    noise = torch.Generator(device=device).manual_seed(_int64(seed * 31 + 17) & ((1 << 63) - 1))

    xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5 - camera["cx"]) / camera["fx"]
    ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5 - camera["cy"]) / camera["fy"]
    dirs = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w),
                        torch.ones(h, w, device=device)], -1)  # [H, W, 3], z = 1

    depth_out = np.empty((frames, h, w), np.uint16)
    color_out = np.empty((frames, h, w, 3), np.uint8)
    for lo_f in range(0, frames, _BATCH):
        hi_f = min(frames, lo_f + _BATCH)
        rot = rot64[lo_f:hi_f].to(device, torch.float32)
        pos = pos64[lo_f:hi_f].to(device, torch.float32)
        d_world = torch.einsum("nij,hwj->nhwi", rot, dirs)  # [F, H, W, 3]
        best = torch.full(d_world.shape[:3], float("inf"), device=device)
        for p, n in zip(pts, nrm):
            denom = d_world @ n
            num = (p[None, :] - pos) @ n  # [F]
            z = num[:, None, None] / denom
            ok = (denom.abs() > 1e-9) & (z > 0.05)
            best = torch.minimum(best, torch.where(ok, z, float("inf")))
        # Boxes by their slabs: z along each ray from its entry to its exit.
        inv = 1.0 / torch.where(d_world.abs() < 1e-12, 1e-12, d_world)
        for least, most in zip(box_lo, box_hi):
            t1 = (least - pos[:, None, None, :]) * inv
            t2 = (most - pos[:, None, None, :]) * inv
            near = torch.minimum(t1, t2).amax(-1)
            far = torch.maximum(t1, t2).amin(-1)
            ok = (near <= far) & (near > 0.05)
            best = torch.minimum(best, torch.where(ok, near, float("inf")))
        hit = torch.isfinite(best)
        world = pos[:, None, None, :] + torch.where(hit, best, 0.0)[..., None] * d_world
        inten = torch.where(hit, _albedo(world, a["cell_m"], a["lo"], a["hi"], salt), 0.0)
        hit &= (best >= sensor["min_range_m"]) & (best <= sensor["max_range_m"])
        depth = torch.where(hit, best, 0.0)
        depth = depth * (1.0 + sensor["depth_bias_quadratic"] * depth)
        sigma = sensor["depth_noise"] * depth * depth
        g = torch.randn(depth.shape, generator=noise, device=device)
        depth = torch.where(hit, torch.clamp_min(depth + sigma * g, 1e-3), 0.0)
        raw = torch.clamp(torch.floor(depth / raw_to_float_depth), 0, 65535)
        g = torch.randn(inten.shape, generator=noise, device=device)
        inten = inten + (sensor["intensity_noise"] / 255.0) * g
        gray = torch.clamp(torch.floor(inten * 255.0 + 0.5), 0, 255).to(torch.uint8)
        depth_out[lo_f:hi_f] = raw.to(torch.int32).cpu().numpy().astype(np.uint16)
        color_out[lo_f:hi_f] = gray[..., None].expand(-1, -1, -1, 3).cpu().numpy()
    rot_np = rot64.numpy()
    return Sequence(depth_out, color_out, _matrix_to_quat(rot_np), pos64.numpy())


def motion_summary(mix: dict, frames: int, rate_hz: float) -> dict:
    """Mean translational speed (m/s) and mean rotation rate (deg/s) of the
    trajectory, for the record."""
    rot, pos = trajectory(mix, frames, rate_hz)
    speed = (pos[1:] - pos[:-1]).norm(dim=-1).mean().item() * rate_hz
    rel = rot[:-1].transpose(-1, -2) @ rot[1:]
    cos = ((rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1, 1)
    rate = math.degrees(torch.arccos(cos).mean().item()) * rate_hz
    return {"speed_mps": speed, "rotation_dps": rate}
