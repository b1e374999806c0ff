"""Smoke run of badslam_torch on one NVIDIA GPU: build, check, drive, report.

    python3 chip_smoke.py [--profile DIR]

Phases (each prints what it finds and its seconds; none catches its own
failure, so any failure exits non-zero before the last line is printed):

1. Device: requires CUDA; prints the card's name and `nvidia-smi`'s name
   and power limit; turns TF32 off.
2. Build: builds every CUDA source of badslam_torch/csrc with nvcc, one
   nvcc per source, all started together; prints each one's seconds and
   what ptxas says about its kernels (entry, registers, spills).
3. Kernels against their plain PyTorch versions on the card, with the
   tolerance stated: K1 (bilateral filter) on random depth at 480x640 and
   67x160 and on a rendered 480x640 frame (the main path's input), atol
   1e-5, each with its grid's registers, spills and waves, and at radius 0
   (the launch, staging and stores alone); K2 (image gather) on the probe's
   480x640 field and batched [4, 480, 640] x [4, 200000], int32 and int64
   indices, with out-of-range
   and negative flat indices, exact (NaN where the plain version gives
   NaN); K3 (one-hot gather) at 480x640, exact. For each: max abs error,
   device time per call (a CUDA graph of 50 calls), eager call latency,
   the plain version's device time, the least time the card could take
   (bytes over 3.35 TB/s or operations over 67 TFLOP/s, whichever is
   larger) and, for K2 and K3, the device time of `torch.take`.
4. The probe path: `badslam_torch.probe_gather.main()` (K2, K3, the
   library gather and the tracker's accumulation at VGA), its JSON line.
5. The slice (the default main path with loop detection off): 30 frames of
   a synthetic plane scene at 640x480 through `badslam_torch.cli.main` on
   cuda, keyframe BA with 10 iterations per keyframe (parallel BA), the
   point cloud exported. Checks K1 ran once per frame, K2 ran, BA ran
   iterations, the map has surfels, every pose is finite, the ATE is below
   1e-3 m and the PLY has points; prints per-frame medians (all frames
   after the first, keyframe frames, frames that drained queued BA
   iterations, the other frames), surfels, keyframes, peak memory and
   launches per kernel. With `--profile DIR` the slice then runs once more
   under the CLI's `--profile`, which writes DIR/profile_summary.json
   (spans, BA stages, kernel launches and device time) and
   DIR/key_averages.txt; the summary's totals are printed.
6. The odometry path: the first 10 frames with BA off; K1 once per frame,
   ATE below 1e-3 m.
7. The card against the CPU: a 160x120, 13-frame BA sequence on both
   devices (poses to 1e-4, surfel counts within 1%), and the first 6 VGA
   odometry frames on the CPU against the CUDA run (poses to 1e-4).
8. The nvidia-smi line again, one JSON line of the kernels, then the last
   line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from badslam_torch import cli, probe_gather, synthetic
from badslam_torch.cuda_timing import call_ms, device_ms
from badslam_torch.io.dataset import load_tum_trajectory
from badslam_torch.ops import kernels
from badslam_torch.ops.interp import gather_nearest_plain, gather_onehot_plain
from badslam_torch.ops.preprocess import bilateral_filter_and_cutoff, shift2d

KERNEL_ATOL = 1e-5
POSE_ATOL = 1e-4
ATE_LIMIT_M = 1e-3
SURFEL_RTOL = 0.01
WIDTH, HEIGHT, FRAMES, ODOMETRY_FRAMES, CPU_FRAMES = 640, 480, 30, 10, 6
# The card's published peaks (H100 SXM data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SLICE_FLAGS = ["--num_scales", "5", "--keyframe_interval", "10",
               "--max_num_ba_iterations_per_keyframe", "10",
               "--enable_loop_detection", "false", "--fps_restriction", "0",
               "--quiet"]
ODOMETRY_FLAGS = ["--num_scales", "5", "--keyframe_interval", "10",
                  "--max_num_ba_iterations_per_keyframe", "0",
                  "--enable_loop_detection", "false", "--fps_restriction", "0",
                  "--end_frame", str(ODOMETRY_FRAMES), "--quiet"]
SMALL_FRAMES = 13
SMALL_FLAGS = ["--num_scales", "4", "--keyframe_interval", "6",
               "--max_surfel_count", str(1 << 14),
               "--max_num_ba_iterations_per_keyframe", "4",
               "--enable_loop_detection", "false", "--fps_restriction", "0",
               "--quiet"]


def _phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase {name}: {time.perf_counter() - t0:.1f} s]", flush=True)
    return out


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible)")
    print(_smi())  # the card's name and power limit, as nvidia-smi gives them
    return name


def phase_build() -> None:
    kernels.build()
    for source in sorted(kernels.build_seconds):
        print(f"build: {source} in {kernels.build_seconds[source]:.2f} s (nvcc)")
        for line in kernels.build_logs.get(source, "").splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {source}: {line.strip()}")


def _bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over the HBM rate, or operations over
    the float32 rate, whichever is larger."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _k1_ops(depth: torch.Tensor, max_depth: float, radius: int) -> float:
    """Operations K1 does on this depth map: per valid center 2 (its
    inverse and the final division), per valid tap of a valid center 10
    (inverse, difference, square, two divisions, subtraction, exp, the
    weight's add, the value's multiply-add)."""
    center = (depth > 0) & (depth <= max_depth)
    taps = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx * dx + dy * dy <= radius * radius:
                taps += int((center & (shift2d(depth, dy, dx) > 0)).sum())
    return 10.0 * taps + 2.0 * float(center.sum())


def _timings(kernel, plain, library=None) -> dict:
    out = {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
           "call_ms": call_ms(kernel), "plain_call_ms": call_ms(plain),
           "library_ms": None if library is None else device_ms(library)}
    return out


def _random_depth(seed: int, shape, max_depth: float) -> torch.Tensor:
    """0.5-3 m, 15% invalid, 5% beyond the cutoff."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    d[rng.uniform(size=shape) < 0.15] = 0.0
    d[rng.uniform(size=shape) < 0.05] = max_depth + 2.0
    return torch.from_numpy(d).cuda()


def _rendered_depth() -> torch.Tensor:
    """What the main path gives K1: the slice's scene (seed 7) rendered at
    VGA, raw u16 depth scaled to metres; smooth, almost all valid."""
    cam = synthetic.default_camera(WIDTH, HEIGHT)
    scene = synthetic.random_plane_scene(np.random.default_rng(7), 6)
    depth, _ = synthetic.render_scene(cam, scene, synthetic.pose(tx=0.01, rz=0.02))
    raw = torch.from_numpy(np.clip(depth * 5000.0, 0, 65535).astype(np.int32))
    return (raw.to(torch.float32) * (1.0 / 5000.0)).cuda()


def _k1_launch(h: int, w: int, radius: int) -> str:
    """K1's grid against the card: registers and local (spill) bytes per
    thread, blocks resident per SM, waves (blocks over SMs x resident
    blocks) and the balance over SMs (mean over most blocks per SM)."""
    i = kernels.bilateral_launch_info(h, w, radius)
    blocks = i["grid_x"] * i["grid_y"]
    waves = blocks / (i["sms"] * i["blocks_per_sm"])
    balance = blocks / (i["sms"] * -(-blocks // i["sms"]))
    return (f"grid {i['grid_x']}x{i['grid_y']} = {blocks} blocks of {i['threads']} "
            f"threads, {i['shared_bytes']} B shared, {i['registers']} registers, "
            f"{i['local_bytes']} B local (spills) per thread, {i['blocks_per_sm']} "
            f"blocks resident per SM on {i['sms']} SMs: {waves:.3f} waves, balance "
            f"{balance:.3f}")


def _k1() -> dict:
    result = {}
    for what, max_depth, depth in (
            (f"random {HEIGHT}x{WIDTH}", 2.5, _random_depth(0, (HEIGHT, WIDTH), 2.5)),
            ("random 67x160", 2.5, _random_depth(1, (67, 160), 2.5)),
            (f"rendered {HEIGHT}x{WIDTH}", 3.0, _rendered_depth())):
        out = kernels.bilateral_filter_and_cutoff_cuda(depth, max_depth)
        ref = bilateral_filter_and_cutoff(depth, max_depth)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        t = _timings(lambda: kernels.bilateral_filter_and_cutoff_cuda(depth, max_depth),
                     lambda: bilateral_filter_and_cutoff(depth, max_depth))
        b = _bound(8.0 * depth.numel(), _k1_ops(depth, max_depth, 3))
        valid = float((depth > 0).float().mean())
        print(f"K1 bilateral {what} ({valid:.3f} valid): max_abs_err {err:.3e} (atol "
              f"{KERNEL_ATOL}); device time per call (CUDA graph of 50, median of "
              f"5) kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; eager call "
              f"latency (median of 50) kernel {t['call_ms']:.4f} ms, plain "
              f"{t['plain_call_ms']:.4f} ms; bound {b['bound_ms']:.5f} ms "
              f"({b['bound_by']}); no single PyTorch call computes it; "
              f"{_k1_launch(*depth.shape, 3)}")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"K1 disagrees with its plain version on {what}: {err}")
        if not result:  # the row: the random VGA input, as in earlier runs
            result = {"max_abs_err": err, **t, **b}
            # Radius 0 (one tap): the launch, the staging and the stores alone.
            fixed = device_ms(lambda: kernels.bilateral_filter_and_cutoff_cuda(
                depth, max_depth, 0.2, 2.0))
            print(f"K1 bilateral {what} at radius 0: device time per call {fixed:.4f} ms")
    return result


def _exact(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Exact equality, NaN where the reference has NaN; returns the max abs
    error over the finite entries (0.0 when equal)."""
    nan = torch.isnan(ref)
    if not torch.equal(nan, torch.isnan(out)):
        raise AssertionError(f"{what}: NaN pattern differs from the plain version")
    err = float((out[~nan] - ref[~nan]).abs().max()) if bool((~nan).any()) else 0.0
    if err != 0.0:
        raise AssertionError(f"{what}: max abs error {err} (must be exact)")
    return err


def _k2() -> dict:
    img_np, px_np, py_np = probe_gather.make_inputs(HEIGHT, WIDTH)
    img = torch.from_numpy(img_np).cuda()
    result = {}
    for dtype in (torch.int64, torch.int32):
        px = torch.from_numpy(px_np).cuda().to(dtype).reshape(1, -1)
        py = torch.from_numpy(py_np).cuda().to(dtype).reshape(1, -1)
        img3 = img[None]
        out = kernels.gather_cuda(img3, px, py)
        err = _exact(out, gather_nearest_plain(img3, px, py), f"K2 probe field {dtype}")
        flat = (py.to(torch.int64) * WIDTH + px.to(torch.int64)).reshape(-1)
        t = _timings(lambda: kernels.gather_cuda(img3, px, py),
                     lambda: gather_nearest_plain(img3, px, py),
                     lambda: torch.take(img, flat))
        n = px.numel()
        b = _bound(4.0 * img.numel() + 2.0 * n * px.element_size() + 4.0 * n, 3.0 * n)
        print(f"K2 gather 480x640 probe field, {dtype}: exact (max_abs_err {err}); "
              f"device ms kernel {t['ms']:.4f}, plain {t['plain_ms']:.4f}, "
              f"torch.take {t['library_ms']:.4f}; eager kernel {t['call_ms']:.4f}, "
              f"plain {t['plain_call_ms']:.4f}; bound {b['bound_ms']:.5f} ms "
              f"({b['bound_by']})")
        if dtype == torch.int64:  # the index type of the port's callers
            result = {"max_abs_err": err, **t, **b}

    rng = np.random.default_rng(3)
    batch, n = 4, 200_000
    imgs = torch.from_numpy(rng.standard_normal((batch, HEIGHT, WIDTH))
                            .astype(np.float32)).cuda()
    px_b = rng.integers(0, WIDTH, (batch, n))
    py_b = rng.integers(0, HEIGHT, (batch, n))
    # A few flat indices out of range and a few negative ones (which wrap
    # once, as jnp.take does).
    py_b[:, :5] = [HEIGHT, -1, -HEIGHT, HEIGHT + 7, -HEIGHT - 1]
    for dtype in (torch.int32, torch.int64):
        px = torch.from_numpy(px_b).cuda().to(dtype)
        py = torch.from_numpy(py_b).cuda().to(dtype)
        out = kernels.gather_cuda(imgs, px, py)
        err = _exact(out, gather_nearest_plain(imgs, px, py), f"K2 batched {dtype}")
        nans = int(torch.isnan(out).sum())
        ms = device_ms(lambda: kernels.gather_cuda(imgs, px, py))
        print(f"K2 gather batched [{batch}, {n}] on [{batch}, {HEIGHT}, {WIDTH}], "
              f"{dtype}: exact (max_abs_err {err}, {nans} NaN outputs); device ms "
              f"{ms:.4f}")
    return result


def _k3() -> dict:
    img_np, px_np, py_np = probe_gather.make_inputs(HEIGHT, WIDTH, seed=5)
    # Move some rows out of their window and some columns out of the image
    # (both read 0).
    py_np[::97, ::13] = np.clip(py_np[::97, ::13] + 9, 0, HEIGHT - 1)
    px_np[5, :7] = WIDTH + 3
    img = torch.from_numpy(img_np).cuda()
    px = torch.from_numpy(px_np).cuda()
    py = torch.from_numpy(py_np).cuda()
    out = kernels.gather_onehot_cuda(img, px, py)
    err = _exact(out, gather_onehot_plain(img, px, py), "K3")
    # The library yardstick runs on the probe's own field, where no pixel
    # is windowed out and torch.take computes the same values.
    _, tpx, tpy = probe_gather.make_inputs(HEIGHT, WIDTH)
    tpx, tpy = torch.from_numpy(tpx).cuda(), torch.from_numpy(tpy).cuda()
    flat = (tpy.to(torch.int64) * WIDTH + tpx.to(torch.int64)).reshape(-1)
    t = _timings(lambda: kernels.gather_onehot_cuda(img, tpx, tpy),
                 lambda: gather_onehot_plain(img, tpx, tpy),
                 lambda: torch.take(img, flat))
    n = img.numel()
    b = _bound(4.0 * n + 8.0 * n + 4.0 * n, 8.0 * n)
    print(f"K3 gather_onehot 480x640: exact (max_abs_err {err}, "
          f"{probe_gather.windowed_out(py_np)} pixels windowed out); device ms "
          f"kernel {t['ms']:.4f}, plain {t['plain_ms']:.4f}, torch.take "
          f"{t['library_ms']:.4f}; eager kernel {t['call_ms']:.4f}, plain "
          f"{t['plain_call_ms']:.4f}; bound {b['bound_ms']:.5f} ms ({b['bound_by']})")
    return {"max_abs_err": err, **t, **b}


def phase_kernels() -> dict:
    return {kernels.BILATERAL: _k1(), kernels.GATHER: _k2(),
            kernels.GATHER_ONEHOT: _k3()}


def phase_probe() -> dict:
    kernels.reset_launch_counts()
    probe_gather.main()
    return dict(kernels.launch_counts)


def _poses(path: str):
    _, poses = load_tum_trajectory(path)
    q = np.stack([p.q for p in poses]).astype(np.float64)
    t = np.stack([p.t for p in poses]).astype(np.float64)
    return poses, q, t


def _ply_points(path: str) -> int:
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"element vertex"):
                return int(line.split()[2])
    raise AssertionError(f"{path}: no vertex count in the PLY header")


def _run(data, workdir, tag, device, flags):
    """cli.main on one device; returns (poses, q, t, summary, launches)."""
    poses_path = os.path.join(workdir, f"{tag}_poses.txt")
    times_path = os.path.join(workdir, f"{tag}_times.json")
    kernels.reset_launch_counts()
    rc = cli.main([data, "--device", device, *flags, "--export_poses", poses_path,
                   "--export_frame_times", times_path])
    launches = dict(kernels.launch_counts)
    if rc != 0:
        raise RuntimeError(f"badslam_torch.cli.main ({tag}) returned {rc}")
    poses, q, t = _poses(poses_path)
    if not (np.all(np.isfinite(q)) and np.all(np.isfinite(t))):
        raise AssertionError(f"{tag}: non-finite poses")
    with open(times_path) as f:
        summary = json.load(f)
    return poses, q, t, summary, launches


def _write(workdir, name, width, height, frames, seed, planes=6):
    data = os.path.join(workdir, name)
    gt = synthetic.smooth_trajectory(frames)
    synthetic.write_tum_dataset(
        data, synthetic.default_camera(width, height),
        synthetic.random_plane_scene(np.random.default_rng(seed), planes), gt)
    return data, gt


def phase_slice(workdir: str) -> tuple:
    data, gt = _write(workdir, "sequence", WIDTH, HEIGHT, FRAMES, 7)
    ply = os.path.join(workdir, "map.ply")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    poses, q, t, summary, launches = _run(
        data, workdir, "slice", "cuda", SLICE_FLAGS + ["--export_point_cloud", ply])
    wall = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ate = synthetic.ate_rmse(poses, gt)
    frame_ms = dict((i, ms) for i, ms in summary["frame_ms"])
    later = [frame_ms[i] for i in sorted(frame_ms)[1:]]
    kf = [frame_ms[i] for i in summary["keyframe_frames"][1:]]
    drain = [frame_ms[i] for i in summary["ba_drain_frames"]
             if i not in summary["keyframe_frames"]]
    other = [frame_ms[i] for i in sorted(frame_ms)[1:]
             if i not in summary["keyframe_frames"]
             and i not in summary["ba_drain_frames"]]
    points = _ply_points(ply)
    print(f"slice: {FRAMES} frames at {WIDTH}x{HEIGHT} on cuda in {wall:.1f} s wall; "
          f"ATE {ate:.3e} m (limit {ATE_LIMIT_M}); per-frame median {statistics.median(later):.2f} ms "
          f"after the first (min {min(later):.2f}, max {max(later):.2f}, first "
          f"{frame_ms[0]:.2f}); keyframe (BA) frames median {statistics.median(kf):.2f} ms "
          f"({len(kf)}: {', '.join(f'{x:.1f}' for x in kf)}); BA-drain frames "
          f"median {statistics.median(drain):.2f} ms ({len(drain)}); other frames "
          f"median {statistics.median(other):.2f} ms ({len(other)}); BA iterations per call "
          f"{summary['ba_iterations']}; keyframes {summary['keyframes']}; surfels "
          f"{summary['surfels']}; PLY points {points}; peak memory {peak_mb:.1f} MiB; "
          f"launches {launches}")
    checks = {
        "K1 once per frame": launches[kernels.BILATERAL] == FRAMES,
        "K2 launched": launches[kernels.GATHER] > 0,
        "BA ran iterations": sum(summary["ba_iterations"]) > 0,
        "surfels in the map": summary["surfels"] > 0,
        f"{FRAMES} poses": len(poses) == FRAMES,
        "ATE below the limit": ate < ATE_LIMIT_M,
        "PLY has points": points > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"slice checks failed: {failed}")
    return data, launches


def phase_profile(data: str, out_dir: str) -> None:
    """The slice once more under the CLI's --profile (timings there carry
    the profiler's overhead; counts are exact)."""
    rc = cli.main([data, "--device", "cuda", *SLICE_FLAGS, "--profile", out_dir])
    if rc != 0:
        raise RuntimeError(f"profiled slice run returned {rc}")
    with open(os.path.join(out_dir, "profile_summary.json")) as f:
        summary = json.load(f)
    spans = {k: (v["count"], round(v["host_ms"], 1)) for k, v in summary["spans"].items()
             if not k.startswith("gn_iteration/")}
    print(f"profile ({out_dir}): {summary['frames']} frames, wall "
          f"{summary['wall_ms']:.1f} ms, {summary['kernel_launches']} kernel launches, "
          f"kernel device time {summary['kernel_device_ms']:.1f} ms, "
          f"{summary['host_syncs_and_copies']} syncs and copies; spans (count, host ms) "
          f"{spans}")


def phase_odometry(workdir: str, data: str) -> tuple:
    poses, q, t, summary, launches = _run(data, workdir, "odometry", "cuda",
                                          ODOMETRY_FLAGS)
    gt = synthetic.smooth_trajectory(ODOMETRY_FRAMES)
    ate = synthetic.ate_rmse(poses, gt)
    later = [ms for _, ms in summary["frame_ms"][1:]]
    print(f"odometry: {ODOMETRY_FRAMES} frames on cuda, BA off; ATE {ate:.3e} m; "
          f"per-frame median {statistics.median(later):.2f} ms after the first; "
          f"launches {launches}")
    if launches[kernels.BILATERAL] != ODOMETRY_FRAMES or not ate < ATE_LIMIT_M:
        raise AssertionError("odometry checks failed")
    return q, t


def phase_cpu(workdir: str, data: str, q_odo, t_odo) -> None:
    small, _ = _write(workdir, "small", 160, 120, SMALL_FRAMES, 5)
    runs = {dev: _run(small, workdir, f"small_{dev}", dev, SMALL_FLAGS)
            for dev in ("cuda", "cpu")}
    (_, qg, tg, sg, _), (_, qc, tc, sc, _) = runs["cuda"], runs["cpu"]
    dq, dt = float(np.abs(qg - qc).max()), float(np.abs(tg - tc).max())
    ds = abs(sg["surfels"] - sc["surfels"]) / max(sc["surfels"], 1)
    print(f"cpu vs cuda, 160x120 BA sequence ({SMALL_FRAMES} frames): max |dq| "
          f"{dq:.3e}, max |dt| {dt:.3e} (atol {POSE_ATOL}); surfels cuda "
          f"{sg['surfels']} cpu {sc['surfels']} (rel diff {ds:.4f}, limit "
          f"{SURFEL_RTOL}); BA iterations cuda {sg['ba_iterations']} cpu "
          f"{sc['ba_iterations']}")
    if not (dq <= POSE_ATOL and dt <= POSE_ATOL and ds <= SURFEL_RTOL):
        raise AssertionError("CPU and CUDA disagree on the BA sequence")

    _, q, t, _, _ = _run(data, workdir, "odometry_cpu", "cpu",
                         ODOMETRY_FLAGS[:-3] + ["--end_frame", str(CPU_FRAMES), "--quiet"])
    dq = float(np.abs(q - q_odo[:CPU_FRAMES]).max())
    dt = float(np.abs(t - t_odo[:CPU_FRAMES]).max())
    print(f"cpu vs cuda, {CPU_FRAMES} VGA odometry frames: max |dq| {dq:.3e}, "
          f"max |dt| {dt:.3e} (atol {POSE_ATOL})")
    if not (len(q) == CPU_FRAMES and dq <= POSE_ATOL and dt <= POSE_ATOL):
        raise AssertionError("CPU and CUDA odometry trajectories disagree")


_KERNEL_ROWS = (
    (kernels.BILATERAL, "badslam_torch/csrc/bilateral.cu",
     "badslam_tpu/ops/pallas_kernels.py:105"),
    (kernels.GATHER, "badslam_torch/csrc/gather.cu",
     "tools/probe_pallas_gather.py:82"),
    (kernels.GATHER_ONEHOT, "badslam_torch/csrc/gather.cu",
     "tools/probe_pallas_gather.py:120"),
)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    profile_dir = None
    if argv:
        if len(argv) != 2 or argv[0] != "--profile":
            raise SystemExit("usage: python3 chip_smoke.py [--profile DIR]")
        profile_dir = os.path.abspath(argv[1])
    name = _phase("device", phase_device)
    _phase("build", phase_build)
    measured = _phase("kernels", phase_kernels)
    probe_launches = _phase("probe", phase_probe)
    with tempfile.TemporaryDirectory() as workdir:
        data, slice_launches = _phase("slice", phase_slice, workdir)
        if profile_dir:
            _phase("profile", phase_profile, data, profile_dir)
        q_odo, t_odo = _phase("odometry", phase_odometry, workdir, data)
        _phase("cpu", phase_cpu, workdir, data, q_odo, t_odo)
    rows = []
    for kname, source, replaces in _KERNEL_ROWS:
        # K1 and K2 are on the SLAM path: their launches are the slice
        # run's. K3 is only on the probe path: its launches are the probe's.
        launches = (probe_launches if kname == kernels.GATHER_ONEHOT
                    else slice_launches)[kname]
        m = measured[kname]
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    print(_smi())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
