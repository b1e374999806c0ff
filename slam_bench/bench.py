"""One run of one cell: set-up, warm-up, the measured window, the record
the metric readers read, and the check of what the window produced.

Set-up (``setup_s``: process start to the window's start):
1. the card: a run that finds none, or fewer than the cell asks for, fails;
   the card's name and power limit are printed;
2. K1's tuning store points at an empty file under TMPDIR, so that a store
   left on the machine cannot pick K1's tile;
3. the port's CUDA sources build into its fixed ``badslam_torch/_build/``
   (the first run in a checkout compiles them, later runs load them);
4. the cell's frames are rendered on the card from the seed
   (``scene.render``) and kept on the host behind the program's video
   interface (``video.FrameStore``);
5. ``badslam_torch.frontend.BadSlam`` is built with the configuration's
   settings;
6. warm-up: the cell's own first keyframe intervals, through the same
   ``BadSlam.run`` calls as the window, which capture the steady frame's
   graph and the first BA graphs.

The window then calls ``BadSlam.run(start, end)`` over consecutive
keyframe intervals, each from a keyframe frame to the frame before the
next keyframe, so each call keeps the points where the program chunks
steady frames and drains the loop worker. The window holds ``seconds`` of
the recording (``window_intervals``: seconds * rate_hz frames, in whole
keyframe intervals), the same frames on every run, so a faster program
does the same work in less time and no BA call falls in or out of the
window with speed; at the camera's rate (the live regime) the window
lasts ``seconds`` of wall time. It ends with a synchronize. Each frame's
upload stays inside the window, as a camera's would. With ``trace`` the
window's first 2 intervals run under the profiler (``trace.Slice``); the
readers that time layers read the untraced rest of the window.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from slam_bench import check, scene, trace
from slam_bench.video import FrameStore, PoseLog, elapsed_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "badslam_tpu")
TRACE_INTERVALS = 2


class NoDevice(RuntimeError):
    """The cell's chips are not there."""


def load_cell(workload: str, bench_path: str = "BENCHMARK.json") -> dict:
    """Everything one cell's run reads, found by the names in
    BENCHMARK.json: its configuration file, traffic mix, check limits
    (limits/<cell>.json) and the metrics it reports."""
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"slam_bench: no workload {workload!r} in {bench_path}")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(cfg_entry["file"]) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "limits", f"{workload}.json")) as f:
        limits = json.load(f)

    def reported(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {"workload": w, "config": cfg, "mix": scene.load_mix(w["traffic"]),
            "limits": limits, "end_to_end": reported(bench["end_to_end"]),
            "per_layer": reported(bench["per_layer"])}


def card(device: torch.device, chips: int) -> dict:
    """The card's name, count and power limit; raises NoDevice where the
    cell's chips are missing."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "power_limit": "n/a"}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA device(s); "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                       f"available")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable: {e}"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit": smi.splitlines()[0] if smi else ""}


def window_intervals(cfg: dict, seconds: float) -> int:
    """The keyframe intervals of the window: `seconds` of the recording at
    the configuration's rate, at least one."""
    k = cfg["settings"]["keyframe_interval"]
    return max(1, int(round(seconds * cfg["rate_hz"] / k)))


def run_cell(cell: dict, seed: int, seconds: float, trace_on: bool, device: str,
             t_start: float, log=print, controls=()) -> dict:
    """One run; returns the result object (the last line's keys) with the
    checks under "checks". Each of `controls` (check.py's lower-precision
    references; the benchmark's own runs take none) is judged on the same
    outputs, under "controls"."""
    from badslam_torch.config import BadSlamConfig
    from badslam_torch.frontend import BadSlam
    from badslam_torch.geometry.camera import PinholeCamera
    from badslam_torch.geometry.se3 import SE3
    from badslam_torch.ops import autotune, kernels
    from badslam_torch.utils.timing import Timing

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, mix, limits = cell["config"], cell["mix"], cell["limits"]
    info = card(dev, cell["workload"]["chips"])
    log(f"device: {info['kind']} x{info['count']}; power limit: {info['power_limit']}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cuda:
        store = os.path.join(tempfile.gettempdir(), "slam_bench", "tuning.json")
        os.makedirs(os.path.dirname(store), exist_ok=True)
        with open(store, "w") as f:
            f.write("{}")
        autotune._TUNING_PATH = store
        kernels.build()
        built = {k: round(v, 2) for k, v in kernels.build_seconds.items()}
        log(f"build: nvcc seconds per source {built}")
        torch.cuda.reset_peak_memory_stats(dev)

    cam_cfg = cfg["camera"]
    k = cfg["settings"]["keyframe_interval"]
    warm_end = cfg["warmup_intervals"] * k
    end = min(cfg["frames"], warm_end + window_intervals(cfg, seconds) * k)
    t0 = time.perf_counter()
    seq = scene.render(cam_cfg, mix, end, cfg["rate_hz"], seed,
                       cfg["raw_to_float_depth"], dev)
    log(f"render: {end} of {cfg['frames']} frames of {cam_cfg['width']}x{cam_cfg['height']} in "
        f"{time.perf_counter() - t0:.2f} s; motion "
        f"{scene.motion_summary(mix, cfg['frames'], cfg['rate_hz'])}")

    settings = dict(cfg["settings"], raw_to_float_depth=cfg["raw_to_float_depth"])
    config = BadSlamConfig(**settings)
    camera = PinholeCamera(fx=cam_cfg["fx"], fy=cam_cfg["fy"], cx=cam_cfg["cx"],
                           cy=cam_cfg["cy"], width=cam_cfg["width"], height=cam_cfg["height"])
    plog = PoseLog(dev)
    first = SE3(seq.gt_q[0].astype(np.float32), seq.gt_t[0].astype(np.float32))
    video = FrameStore(camera, seq.depth_u16, seq.color_u8, cfg["rate_hz"], first,
                       cfg["frames"], plog)
    slam = BadSlam(config, video, dev)
    try:
        record, outputs = _drive(cfg, slam, seq, plog, end, trace_on, dev, t_start,
                                 Timing, kernels, log)
    finally:
        slam.close()
    # The program's state goes before the reference runs.
    del slam
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks = check.evaluate(cfg, limits, mix, seq, seed, dev, log=log, **outputs)
    log(f"check: {time.perf_counter() - t_check:.1f} s")
    judged = {name: check.evaluate(cfg, limits, mix, seq, seed, dev, control=name, log=log,
                                   **outputs) for name in controls}

    metrics = {}
    for m in cell["per_layer"] if trace_on else cell["end_to_end"]:
        value = importlib.import_module(f"slam_bench.metrics.{m['name']}").read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": info["platform"], "kind": info["kind"], "count": info["count"],
              "memory_peak_bytes": record["peak_bytes"]}
    result = {"correct": check.passed(checks), "attempted": record["frames"],
              "failed": checks["poses_missing"]["value"], "metrics": metrics,
              "device": device}
    t = record["trace"]
    if trace_on and t and t.get("found"):
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    if judged:
        result["controls"] = judged
    result["checks"] = checks
    return result


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _drive(cfg, slam, seq, plog, n, trace_on, dev, t_start, Timing, kernels, log):
    """Warm-up and window (frames up to `n`); returns the record the
    readers read and the program's outputs that the reference judges (on
    the host)."""
    k = cfg["settings"]["keyframe_interval"]
    warm_end = cfg["warmup_intervals"] * k
    for s in range(0, warm_end, k):
        slam.run(s, s + k)

    def layer_state():
        """What the span readers difference (a device read: outside timing)."""
        _sync(dev)
        return {"frame": None, "ba_calls": len(slam.direct_ba.ba_spans.ms()),
                "captures": len(slam.ba_graph.captures) if slam.ba_graph else 0,
                "gn": slam.steady_gn_iterations(), "timing": Timing.snapshot()}

    state = layer_state()
    _sync(dev)
    log_start = len(plog.entries)
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    mark0 = plog.mark()
    i = warm_end
    sliced = None
    if trace_on and dev.type == "cuda":
        launches = dict(kernels.launch_counts)
        with trace.Slice(dev) as sliced:
            for _ in range(TRACE_INTERVALS):
                slam.run(i, min(n, i + k))
                i = min(n, i + k)
        state = layer_state()
        launches = {name: kernels.launch_counts[name] - v for name, v in launches.items()}
    t_post = time.perf_counter()
    state["frame"] = i
    while i < n:
        slam.run(i, min(n, i + k))
        i = min(n, i + k)
    mark1 = plog.mark()
    _sync(dev)
    t_end = time.perf_counter()
    window_s = t_end - t_win
    frames = list(range(warm_end, i))
    log(f"window: frames {warm_end}-{i - 1} ({len(frames)}) in {window_s:.3f} s; "
        f"set-up {setup_s:.3f} s")

    # The benchmark's own clock of each frame: from the previous frame's
    # pose write (or the window's start) to its own, the window's tail
    # going to its last frame.
    entries = plog.entries[log_start:]
    marks = [mark0] + [e[3] for e in entries] + [mark1]
    latency = [elapsed_ms(a, b) for a, b in zip(marks[:-1], marks[1:])]
    if len(latency) > len(entries) and len(latency) > 1:
        latency[-2] += latency.pop()

    post = [f for f in frames if f >= state["frame"]]
    post_set = set(post)
    spans = {f: ms for f, ms in slam.frame_times_ms if f in post_set}
    ba_ms = slam.direct_ba.ba_spans.ms()[state["ba_calls"]:]
    captures = slam.ba_graph.captures[state["captures"]:] if slam.ba_graph else []
    timing = Timing.snapshot()
    record = {
        "frames": len(frames), "window_s": window_s, "setup_s": setup_s,
        "latency_ms": latency, "slice_frames": state["frame"] - warm_end,
        "post_frames": post, "post_wall_s": t_end - t_post, "span_ms": spans,
        "keyframe_frames": [f for f in slam.keyframe_frames if f in post_set],
        "drain_frames": [f for f in slam.ba_drain_frames if f in post_set],
        "ba_ms": ba_ms, "captures": captures,
        "gn_iterations": slam.steady_gn_iterations() - state["gn"],
        "timing_s": {name: (cnt - state["timing"].get(name, (0, 0.0))[0],
                            tot - state["timing"].get(name, (0, 0.0))[1])
                     for name, (cnt, tot) in timing.items()},
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
        "trace": None, "k1_least_s": [],
    }
    log(f"program: keyframes {len(slam.keyframe_frames)}, BA calls in window "
        f"{len(ba_ms)}, BA captures in window {len(captures)}, closures "
        f"{slam.loop_closure_count}, surfels {int(slam.direct_ba.surfels.valid.sum())}, "
        f"launches {dict(kernels.launch_counts)}")
    if sliced is not None:
        record["trace"] = trace.reduce(sliced.prof)
        sliced.prof = None
        t = record["trace"]
        covered = sum(record["latency_ms"][:state["frame"] - warm_end]) / 1e3
        log(f"trace: {t.get('device_op_count')} device operations over "
            f"{t.get('window_s')} s, busy {t.get('busy_s')} s; the slice's frames "
            f"span {covered:.3f} s of the device's clock; launches in the trace / "
            f"counted: K1 {len(t.get('k1', []))} / {launches['bilateral_filter_and_cutoff']}, "
            f"K2 {len(t.get('k2', []))} / {launches['gather']}")
        from slam_bench import roofline
        s = cfg["settings"]
        radius = int(s["bilateral_filter_radius_factor"] * s["bilateral_filter_sigma_xy"] + 0.5)
        for f in range(warm_end, state["frame"]):
            d = torch.from_numpy(seq.depth_u16[f].astype(np.float32)).to(dev) \
                * cfg["raw_to_float_depth"]
            record["k1_least_s"].append(roofline.k1_least_seconds(d, s["max_depth"], radius))

    # Each closure attempt, with the distance the ground truth puts between
    # the two keyframes' cameras.
    slot_frame = dict(enumerate(slam.direct_ba.keyframes.frame_indices))
    for a in slam.closure_attempts:
        f_kf, f_m = slot_frame.get(a["kf"], -1), slot_frame.get(a["matched"], -1)
        apart = float(np.linalg.norm(seq.gt_t[f_kf] - seq.gt_t[f_m])) if min(f_kf, f_m) >= 0 \
            else float("nan")
        log(f"closure attempt at frame {a['frame']}: keyframe of frame {f_kf} against "
            f"keyframe of frame {f_m} ({apart:.3f} m apart in the ground truth), "
            f"consistent {a['consistent']}, needed {a['needed']}")

    # The program's outputs the reference judges, on the host.
    ks = slam.direct_ba.keyframes
    free = ks.free_slot_set
    kf_q = ks.q[:ks.count].double().cpu().numpy()
    kf_t = ks.t[:ks.count].double().cpu().numpy()
    outputs = {
        "window_frames": frames,
        "poses": {e[0]: tuple(x.detach().cpu().numpy() for x in e[1:3])
                  for e in plog.entries},
        "keyframe_frames": list(slam.keyframe_frames),
        "kf_poses": {f: (kf_q[s], kf_t[s]) for s, f in enumerate(ks.frame_indices[:ks.count])
                     if f >= 0 and s not in free},
        "surfels": slam.direct_ba.export_point_cloud(refresh_colors=False)[0],
    }
    plog.entries.clear()
    return record, outputs


def forbidden_modules() -> list:
    """The JAX modules, or the JAX package's, loaded in this process
    (compared by whole top-level names)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
