"""Whether what the window produced is correct: the program's outputs
judged by the benchmark's plain reference (``reference/``), which imports
nothing of the program and takes from it only the outputs it judges.

The numbers, each beside its limit (``limits/<cell>.json``; a number
whose limit the file does not give is logged and not compared):

* ``poses_missing``: frames of the window whose pose the program never
  wrote (limit 0). A frame whose answer never comes is not correct.
* ``pose_gap_p50_um``: the steady frame (K1, the pyramid, the tracker).
  Over a sample of the window's keyframe intervals drawn from the seed,
  the reference preprocesses the keyframe's frame and every steady frame
  after it from the raw images (bilateral filter, deformation, normals,
  radii), builds their pyramids and tracks the steady frames against the
  keyframe in sequence, coarse to fine, with the constant-motion model's
  two estimates taken from its own earlier results. The steady frames of
  one interval are all tracked against the same keyframe pose, so the
  pose each writes, relative to the pose the interval's first steady
  frame wrote, is the tracker's alone: the number is the median over the
  sampled frames of the gap between the program's relative pose and the
  reference's, as |dt| + 1 m * |dtheta|, in micrometres. (Not the
  largest: the tracker stops a level once its step falls under 1e-4, and
  where the two sides' steps straddle that line one frame's gap reaches
  tens of micrometres either way; the median moves with the precision of
  the work.) It takes nothing from the program but the poses it wrote.
* ``map_miss_pct``: over a sample of the window's keyframes drawn from the
  seed (not the newest few, whose new surfaces are still waiting for
  observations), the share of image cells with valid measured depth that
  no surfel of the final map explains when projected from that keyframe's
  final pose: a surfel explains a cell when it projects into it within
  ``tau_m + tau_quad * d^2`` of the depth measured at its pixel. Surfel
  creation, merge and deletion, which keyframe BA runs, make or break it.
* ``surfel_noise_mm``: keyframe BA's geometry pass against the scene's
  ground truth. Each surfel of the final map that lies on a plane of the
  scene (and on no box) has a signed distance to that plane; the sensor's
  bias moves it smoothly with the viewing depth, and the noise of the
  depths it was made from moves it from one surfel to the next. So the
  surfels are grouped by plane and by cells of ``noise_cell_m`` across it,
  and the number is the median over cells of the spread (standard
  deviation) of the signed distances within a cell: a geometry pass that
  averages a surfel over the keyframes that observe it lowers it, one left
  out leaves each surfel where one depth image put it.
* ``kf_drift_mm``: keyframe BA's pose pass against the ground truth. The
  window's keyframes' final poses relative to the window's first
  keyframe, against the ground truth's relative poses, after the one
  scale that fits their relative positions best (the sensor's depth bias
  scales the whole reconstruction by a few parts in a thousand, which no
  BA removes): the largest |dt| + 1 m * |dtheta|, in millimetres.
``control`` runs the same comparison with the reference in the program's
place, computed in a lower precision: ``"tf32"`` (its matrix products in
TF32), or ``"bf16"`` (TF32, every pyramid plane stored in bfloat16, and the
map and keyframe poses judged as bfloat16).

Rounding that the check cannot see: TF32 in the program's Gauss-Newton
reductions moves no pose by more than the program's own K1 does (PERF.md),
so a change that turns it on there passes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from slam_bench import scene
from slam_bench.reference import frame as rframe
from slam_bench.reference import geometry as se3
from slam_bench.reference.tracker import track_frame_pairwise


def _sample(items: list, count: int, seed: int, salt: int) -> list:
    """`count` of `items` (all when fewer), drawn from the seed, in order."""
    if len(items) <= count:
        return list(items)
    gen = torch.Generator().manual_seed((seed * 1000003 + salt) & ((1 << 63) - 1))
    pick = torch.randperm(len(items), generator=gen)[:count].sort().values.tolist()
    return [items[i] for i in pick]


class Reference:
    """The reference's view of one configuration: cameras and settings."""

    def __init__(self, cfg: dict, device, control: Optional[str] = None):
        c = cfg["camera"]
        b = cfg["settings"]
        self.device = torch.device(device)
        self.cam = se3.PinholeCamera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"],
                                     c["height"])
        self.s = b
        self.cams = tuple(self.cam.pyramid_level(i) for i in range(b["num_scales"]))
        cell = b["sparse_surfel_cell_size"]
        self.a = torch.zeros((), dtype=torch.float32, device=self.device)
        self.cfactor = torch.zeros(((c["height"] - 1) // cell + 1, (c["width"] - 1) // cell + 1),
                                   dtype=torch.float32, device=self.device)
        self.raw_to_float = cfg["raw_to_float_depth"]
        self.control = control

    def pyramid(self, depth_u16: np.ndarray, color_u8: np.ndarray):
        s = self.s
        depth = torch.from_numpy(depth_u16.astype(np.int32)).to(self.device)
        rgb = torch.from_numpy(np.ascontiguousarray(color_u8)).to(self.device)
        f = rframe.preprocess_frame(
            self.cam, depth, rgb, max_depth=s["max_depth"],
            sigma_xy=s["bilateral_filter_sigma_xy"],
            radius_factor=s["bilateral_filter_radius_factor"],
            sigma_inv_depth=s["bilateral_filter_sigma_inv_depth"], a=self.a,
            cfactor=self.cfactor, cell_size=s["sparse_surfel_cell_size"],
            raw_to_float_depth=self.raw_to_float)
        pyr = rframe.build_pyramid(f.depth, f.nx, f.ny, f.intensity, s["num_scales"],
                                   gradmag=s["use_gradmag"])
        if self.control == "bf16":
            pyr = tuple(rframe.FramePyramidLevel(
                *(p.to(torch.bfloat16).to(torch.float32) for p in level)) for level in pyr)
        return pyr

    def track(self, base_pyr, pyr, e1: se3.SE3, e2: se3.SE3, test_two: bool) -> se3.SE3:
        s = self.s
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.control in ("tf32", "bf16")
        try:
            res = track_frame_pairwise(
                self.cams, base_pyr, pyr, e1.q, e1.t, e2.q, e2.t,
                baseline_fx=s["baseline_fx"], use_depth=s["use_geometric_residuals"],
                use_descriptor=s["use_photometric_residuals"] and not s["use_gradmag"],
                use_gradmag=s["use_gradmag"], test_two_initial_estimates=test_two,
                max_iterations=s["tracking_max_iterations"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        return se3.SE3(res.q, res.t)


def rotation_angle(qa: torch.Tensor, qb: torch.Tensor) -> float:
    """The angle (rad) of the rotation between two unit quaternions, from
    their relative quaternion's vector part (well conditioned near 0)."""
    rel = se3.quat_mul(se3.quat_conj(qa), qb)
    return 2.0 * math.atan2(float(torch.linalg.vector_norm(rel[1:])), abs(float(rel[0])))


def _motion_model(hist: List[se3.SE3], test_two: bool, use: bool):
    """The constant-motion model's two estimates from the identity-padded
    history of the last three base_T_frame, oldest first."""
    last = hist[2]
    if not use:
        return last, last
    prev = hist[1]
    e1 = se3.mul(last, se3.mul(se3.inverse(prev), last))
    if not test_two:
        return e1, e1
    pm = se3.mul(se3.inverse(hist[0]), prev)
    return e1, se3.mul(prev, se3.mul(pm, pm))


def interval_poses(ref: Reference, seq, keyframe: int, frames: List[int]
                   ) -> Dict[int, se3.SE3]:
    """The reference's base_T_frame of each of `frames` (the steady frames
    after the keyframe at frame `keyframe`, in order), each tracked against
    the keyframe with the motion model's estimates from the reference's own
    results for the frames before it."""
    dev = ref.device
    base = ref.pyramid(seq.depth_u16[keyframe], seq.color_u8[keyframe])
    ident = se3.identity(dev)
    hist = [ident, ident, ident]
    out = {}
    for i in frames:
        test_two = ref.s["use_motion_model"] and (i - keyframe) >= 3
        e1, e2 = _motion_model(hist, test_two, ref.s["use_motion_model"])
        rel = ref.track(base, ref.pyramid(seq.depth_u16[i], seq.color_u8[i]), e1, e2, test_two)
        out[i] = rel
        hist = hist[1:] + [rel]
    return out


def _intervals(window_frames: List[int], keyframe_frames: List[int]) -> Dict[int, List[int]]:
    """The window's keyframe intervals whose steady frames all lie in the
    window: keyframe frame -> its steady frames."""
    inside = set(window_frames)
    kfs = sorted(keyframe_frames)
    out = {}
    for k, nxt in zip(kfs[:-1], kfs[1:]):
        steady = list(range(k + 1, nxt))
        if k in inside and len(steady) >= 2 and all(f in inside for f in steady):
            out[k] = steady
    return out


def pose_gap(q_a, t_a, q_b, t_b) -> float:
    """|dt| + 1 m * |dtheta| between two poses, in metres (float64)."""
    dt = float(torch.linalg.vector_norm(t_a.double() - t_b.double()))
    return dt + rotation_angle(q_a.double(), q_b.double())


def map_miss(ref: Reference, seq, kf_poses: Dict[int, tuple], surfels: np.ndarray,
             frames: List[int], cell_px: int, tau_m: float, tau_quad: float) -> float:
    """The share (%) of valid-depth cells of the keyframes at `frames` that
    no surfel explains (module docstring); `kf_poses[f]` is the keyframe
    at frame f's world_T_frame (q, t) as float64 host arrays."""
    dev = ref.device
    cam = ref.cam
    pos = torch.as_tensor(surfels, dtype=torch.float64, device=dev)
    h, w = cam.height, cam.width
    hc, wc = (h + cell_px - 1) // cell_px, (w + cell_px - 1) // cell_px
    considered = explained = 0
    for f in frames:
        q, t = kf_poses[f]
        rot = se3.quat_to_matrix(torch.as_tensor(q, dtype=torch.float64, device=dev))
        pc = (pos - torch.as_tensor(t, dtype=torch.float64, device=dev)) @ rot
        z = pc[:, 2]
        front = z > 0.05
        zs = torch.where(front, z, 1.0)
        u = torch.floor(cam.fx * pc[:, 0] / zs + cam.cx)
        v = torch.floor(cam.fy * pc[:, 1] / zs + cam.cy)
        inside = front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        ui, vi = u[inside].long(), v[inside].long()
        depth = torch.from_numpy(seq.depth_u16[f].astype(np.float64)).to(dev) * ref.raw_to_float
        valid = (depth > 0) & (depth <= ref.s["max_depth"])
        dm = depth[vi, ui]
        ok = (dm > 0) & (dm <= ref.s["max_depth"]) & (
            (z[inside] - dm).abs() <= tau_m + tau_quad * dm * dm)
        hit = torch.zeros(hc * wc, dtype=torch.bool, device=dev)
        hit[(vi[ok] // cell_px) * wc + ui[ok] // cell_px] = True
        pad = torch.zeros(hc * cell_px, wc * cell_px, device=dev)
        pad[:h, :w] = valid.double()
        share = pad.reshape(hc, cell_px, wc, cell_px).mean(dim=(1, 3)).reshape(-1)
        cells = share >= 0.5
        considered += int(cells.sum())
        explained += int((cells & hit).sum())
    return 100.0 * (1.0 - explained / max(considered, 1))


def surfel_noise(mix: dict, surfels: np.ndarray, cell_m: float, device) -> float:
    """The median over (plane, cell) groups of at least 4 surfels of the
    standard deviation (mm) of their signed distances to the plane
    (module docstring)."""
    x = torch.as_tensor(surfels, dtype=torch.float64, device=device)
    pts, nrm = (p.to(device) for p in scene.planes(mix))
    if len(x) == 0 or len(pts) == 0:
        return float("nan")
    sd = ((x[:, None, :] - pts[None]) * nrm[None]).sum(-1)  # [N, P]
    pid = sd.abs().argmin(dim=1)
    d = sd.gather(1, pid[:, None])[:, 0]
    keep = d.abs() < 0.05
    lo, hi = scene.boxes(mix)
    for least, most in zip(lo.to(device), hi.to(device)):  # off the boxes
        keep &= torch.clamp_min(torch.maximum(least - x, x - most), 0.0).norm(dim=-1) > 0.05
    x, d, pid = x[keep], d[keep], pid[keep]
    n = nrm[pid]
    axis = torch.eye(3, dtype=torch.float64, device=device)[n.abs().argmin(dim=1)]
    u = torch.linalg.cross(n, axis)
    u = u / u.norm(dim=-1, keepdim=True)
    v = torch.linalg.cross(n, u)
    key = torch.stack([pid, torch.floor((x * u).sum(-1) / cell_m).long(),
                       torch.floor((x * v).sum(-1) / cell_m).long()], -1)
    _, group, count = torch.unique(key, dim=0, return_inverse=True, return_counts=True)
    g = len(count)
    mean = torch.zeros(g, dtype=torch.float64, device=device).index_add_(0, group, d) / count
    var = torch.zeros(g, dtype=torch.float64, device=device).index_add_(
        0, group, (d - mean[group]) ** 2) / (count - 1).clamp_min(1)
    full = count >= 4
    if not bool(full.any()):
        return float("nan")
    return 1e3 * float(var[full].sqrt().median())


def kf_drift(seq, kf_poses: Dict[int, tuple], frames: List[int]) -> float:
    """The largest gap (mm) of the keyframes at `frames` relative to the
    first, against the ground truth, after the one scale that best fits
    their relative positions (module docstring)."""
    if len(frames) < 3:
        return float("nan")

    def rel(q0, t0, q, t):
        r0 = se3.quat_to_matrix(torch.as_tensor(q0, dtype=torch.float64)).numpy()
        r = se3.quat_to_matrix(torch.as_tensor(q, dtype=torch.float64)).numpy()
        return r0.T @ r, r0.T @ (np.asarray(t, np.float64) - np.asarray(t0, np.float64))

    f0 = frames[0]
    got = [rel(*kf_poses[f0], *kf_poses[f]) for f in frames]
    want = [rel(seq.gt_q[f0], seq.gt_t[f0], seq.gt_q[f], seq.gt_t[f]) for f in frames]
    tg_all, tw_all = np.stack([g[1] for g in got]), np.stack([w[1] for w in want])
    scale = float((tg_all * tw_all).sum() / max((tg_all * tg_all).sum(), 1e-30))
    worst = 0.0
    for (rg, tg), (rw, tw) in zip(got, want):
        dt = np.linalg.norm(scale * tg - tw)
        rr = rw.T @ rg
        ang = math.acos(max(-1.0, min(1.0, (np.trace(rr) - 1) / 2)))
        worst = max(worst, dt + ang)
    return 1e3 * worst


def evaluate(cfg: dict, limits: dict, mix: dict, seq, seed: int, device,
             window_frames: List[int], poses: Dict[int, tuple], keyframe_frames: List[int],
             kf_poses: Dict[int, tuple], surfels: np.ndarray, control: Optional[str] = None,
             log=print) -> Dict[str, dict]:
    """The numbers compared, each as {"value", "limit"}. With `control`,
    the reference in a lower precision takes the program's place."""
    ref = Reference(cfg, device, control)
    exact = Reference(cfg, device) if control else ref
    missing = [i for i in window_frames if i not in poses]
    intervals = _intervals([i for i in window_frames if i in poses], keyframe_frames)
    gaps = {}
    for k in _sample(sorted(intervals), limits["intervals_checked"], seed, 1):
        steady = intervals[k]
        want = interval_poses(exact, seq, k, steady)
        if control is None:  # the program's poses
            got = {i: se3.SE3(torch.as_tensor(poses[i][0], device=ref.device),
                              torch.as_tensor(poses[i][1], device=ref.device)) for i in steady}
        else:  # the reference's, in a lower precision, in the program's place
            got = interval_poses(ref, seq, k, steady)
        first = steady[0]
        for i in steady[1:]:
            g = se3.mul(se3.inverse(got[first]), got[i])
            w = se3.mul(se3.inverse(want[first]), want[i])
            gaps[i] = pose_gap(g.q.cpu(), g.t.cpu(), w.q.cpu(), w.t.cpu())
    if control == "bf16":  # the map and keyframe poses held in bfloat16
        surfels = torch.as_tensor(surfels).to(torch.bfloat16).double().numpy()
        kf_poses = {f: tuple(torch.as_tensor(x).to(torch.bfloat16).double().numpy()
                             for x in p) for f, p in kf_poses.items()}
    window_kfs = sorted(f for f in kf_poses if window_frames and f >= window_frames[0])
    settled = window_kfs[:max(0, len(window_kfs) - limits["fresh_keyframes"])]
    kf_sample = _sample(settled, limits["keyframes_checked"], seed, 2)
    miss = map_miss(ref, seq, kf_poses, surfels, kf_sample, limits["cell_px"],
                    limits["tau_m"], limits["tau_quad"]) if kf_sample else 100.0
    noise = surfel_noise(mix, surfels, limits["noise_cell_m"], ref.device)
    drift = kf_drift(seq, kf_poses, settled)
    um = np.array([1e6 * g for g in gaps.values()]) if gaps else np.full(2, np.inf)
    p90 = np.percentile(um, 90) if gaps else np.inf
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    values = {"poses_missing": len(missing), "pose_gap_p50_um": float(np.median(um)),
              "map_miss_pct": miss, "surfel_noise_mm": noise, "kf_drift_mm": drift}
    log(f"checks{' of control ' + control if control else ''}: pose gaps (um) of "
        f"{len(gaps)} frames: median {np.median(um):.4g}, p90 {p90:.4g}, "
        "worst " + ", ".join(f"frame {i}: {1e6 * g:.4g}" for i, g in worst)
        + f"; map miss {miss:.4g}%; surfel noise {noise:.4g} mm; keyframe drift "
        f"{drift:.4g} mm over {len(settled)} keyframes")
    out = {"poses_missing": {"value": len(missing), "limit": 0}}
    for name, value in values.items():
        if name in limits:
            out[name] = {"value": value, "limit": limits[name]}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    """Every number within its limit (a number that could not be read, NaN,
    is not)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
