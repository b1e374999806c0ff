"""Command-line entry point of the port.

Run as

    python -m badslam_torch <dataset_dir> --device cuda \\
        --export_point_cloud map.ply \\
        [--final_ba] [--save_state s.npz | --load_state s.npz] \\
        [--optimize_intrinsics true --export_calibration calib] \\
        [--use_pcg true --parallel_ba false]

The flags mirror ``badslam_tpu.cli``: every ``BadSlamConfig`` field is a
flag of the same name, type and default. ``--device`` picks the device
(default ``cuda``; there is no fallback to the CPU when CUDA is missing).
``--optimize_intrinsics true`` self-calibrates the camera and the depth
deformation during BA; ``--use_pcg true`` runs the PCG solver for the
keyframe BA (with ``--parallel_ba false``; with parallel BA it warns and
runs the alternating solver) and for ``--final_ba``. Loop detection is on
by default (``--enable_loop_detection``, on a worker thread with
``--parallel_loop_detection``; the ``--loop_detection_*`` flags set the
detection images, their rate and a vocabulary file), and closures still in
flight are applied before the final BA. Live input, the viewer and
``--n_devices`` above 1 are refused with NotImplementedError, naming the
later slice that brings them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from badslam_torch.config import BadSlamConfig

# Output and mode flags of badslam_tpu.cli that the port does not do yet,
# each with the later slice that brings it.
_LATER_FLAGS = {
    "live": "live input comes with the IO slice",
    "export_viewer": "the map viewer comes with the IO slice",
    "live_viewer_dir": "the map viewer comes with the IO slice",
    "save_timings": "per-BA-run timing rows come with the port's benchmark",
}
_LATER_SWITCHES = {
    "autotune": "the port has no tuned variants to pick between",
}


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="badslam_torch",
        description="Direct RGB-D SLAM in PyTorch + CUDA",
    )
    p.add_argument("dataset", nargs="?", default=None,
                   help="TUM/ETH3D-format dataset directory")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda, cuda:N or cpu "
                        "(cuda fails when CUDA is not available)")
    p.add_argument("--trajectory_filename", default=None,
                   help="optional ground-truth/init trajectory in the dataset dir")

    # Mirror BadSlamConfig fields as flags.
    cfg = BadSlamConfig()
    for f in dataclasses.fields(BadSlamConfig):
        default = getattr(cfg, f.name)
        if isinstance(default, bool):
            p.add_argument(f"--{f.name}", type=_bool, default=default,
                           metavar="BOOL")
        elif isinstance(default, int):
            p.add_argument(f"--{f.name}", type=int, default=default)
        elif isinstance(default, float):
            p.add_argument(f"--{f.name}", type=float, default=default)
        else:
            p.add_argument(f"--{f.name}", type=str, default=default)

    p.add_argument("--export_poses", default=None,
                   help="write the final trajectory in TUM format to this path")
    p.add_argument("--export_point_cloud", default=None,
                   help="write the final surfel map as a binary PLY to this path")
    p.add_argument("--export_frame_times", default=None,
                   help="write per-frame times (ms; CUDA events on a GPU), the "
                        "keyframe frames, the frames that drained queued BA "
                        "iterations, the keyframe frames that self-"
                        "calibrated, the loop closures and closure attempts, "
                        "the iterations of each BA call, the CG "
                        "steps of each PCG outer iteration, the ms of each "
                        "intrinsics step and PCG outer iteration, the final "
                        "keyframe and surfel counts and, where they ran, the "
                        "seconds of the final BA (and its calls' iterations), "
                        "of --load_state and of --save_state as JSON to this "
                        "path")
    p.add_argument("--profile", default=None,
                   help="profile the run with torch.profiler and write "
                        "key_averages.txt and profile_summary.json (spans, "
                        "kernel launches, device time) into this directory")
    p.add_argument("--save_state", default=None,
                   help="write a full state snapshot (.npz) after the run")
    p.add_argument("--load_state", default=None,
                   help="resume from a state snapshot (of either package) "
                        "before processing; the snapshot's config is used")
    p.add_argument("--export_calibration", default=None,
                   help="write calibration text files with this prefix")
    p.add_argument("--final_ba", action="store_true",
                   help="run windowed + global final BA after the frame loop")
    p.add_argument("--final_ba_window_size", type=int, default=16)
    p.add_argument("--final_ba_window_stride", type=int, default=8)
    p.add_argument("--quiet", action="store_true")
    for name, why in _LATER_FLAGS.items():
        p.add_argument(f"--{name}", default=None, help=f"not supported: {why}")
    for name, why in _LATER_SWITCHES.items():
        p.add_argument(f"--{name}", action="store_true",
                       help=f"not supported: {why}")
    return p


def config_from_args(args) -> BadSlamConfig:
    return BadSlamConfig(**{f.name: getattr(args, f.name)
                            for f in dataclasses.fields(BadSlamConfig)})


def resolve_device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available (pass --device cpu to "
            f"run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: only cuda and cpu are supported")
    return device


def _profiled_run(slam, out_dir: str, progress: bool, start=None) -> None:
    """slam.run() under torch.profiler; writes the key_averages table and a
    JSON summary: per span (upload, preprocess, pyramid, track, duel,
    gn_iteration/width<W>, ba, ba_drain, the BA stages ba/<stage>,
    trajectory_deformation, loop_drain_wait, loop_closure_attempt) its
    count and host ms, and the number of device
    kernel launches, their device ms, and the host-side synchronizations."""
    import os
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if slam.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        slam.run(start=start, progress=progress)
        if slam.device.type == "cuda":
            torch.cuda.synchronize(slam.device)
    wall_ms = 1000.0 * (time.perf_counter() - t0)

    events = prof.key_averages()
    # A span appears twice: as a host event and as a device annotation.
    spans = {e.key: {"count": e.count, "host_ms": e.cpu_time_total / 1000.0}
             for e in events
             if e.device_type.name == "CPU"
             and (e.key in ("upload", "preprocess", "pyramid", "track", "duel",
                            "ba", "ba_drain", "trajectory_deformation",
                            "loop_drain_wait", "loop_closure_attempt")
                  or e.key.startswith(("gn_iteration/", "ba/")))}
    kernels = [e for e in events
               if e.device_type.name == "CUDA" and not e.is_user_annotation]
    syncs = sum(e.count for e in events
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                             "cudaEventSynchronize", "cudaMemcpyAsync"))
    device_ms = sum(e.self_device_time_total for e in kernels) / 1000.0
    summary = {
        "device": str(slam.device),
        "frames": len(slam.frame_times_ms),
        "wall_ms": wall_ms,
        "spans": spans,
        "kernel_launches": sum(e.count for e in kernels),
        "kernel_device_ms": device_ms,
        "host_syncs_and_copies": syncs,
        "top_kernels": sorted(
            ({"name": e.key[:120], "count": e.count,
              "device_ms": e.self_device_time_total / 1000.0} for e in kernels),
            key=lambda k: -k["device_ms"])[:15],
    }
    os.makedirs(out_dir, exist_ok=True)
    sort_by = "self_device_time_total" if len(activities) > 1 else "self_cpu_time_total"
    with open(os.path.join(out_dir, "key_averages.txt"), "w") as f:
        f.write(events.table(sort_by=sort_by, row_limit=60))
    with open(os.path.join(out_dir, "profile_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None):
    """What `main` does; returns the BadSlam after its run and exports."""
    import torch

    args = build_parser().parse_args(argv)
    refused = [f"--{name}: {why}" for name, why in _LATER_FLAGS.items()
               if getattr(args, name) is not None]
    refused += [f"--{name}: {why}" for name, why in _LATER_SWITCHES.items()
                if getattr(args, name)]
    if refused:
        raise NotImplementedError("badslam_torch: " + "; ".join(refused))
    if not args.dataset:
        build_parser().error("a dataset directory is required")
    config = config_from_args(args)

    from badslam_torch.frontend import BadSlam, check_supported
    from badslam_torch.io import state
    from badslam_torch.io.dataset import load_tum_dataset

    if not args.load_state:  # a resumed run takes the snapshot's config
        check_supported(config)
    device = resolve_device(args.device)
    video = load_tum_dataset(args.dataset, args.trajectory_filename)
    timings = {}
    if args.load_state:
        t0 = time.perf_counter()
        slam = state.load_state(args.load_state, video, device)
        timings["load_state_s"] = time.perf_counter() - t0
        start = slam.last_frame_index + 1
    else:
        slam = BadSlam(config, video, device)
        start = None
    try:
        if args.profile:
            _profiled_run(slam, args.profile, progress=not args.quiet, start=start)
        else:
            slam.run(start=start, progress=not args.quiet)
    finally:
        slam.close()
    if args.final_ba:
        calls = len(slam.direct_ba.iterations_run)
        t0 = time.perf_counter()
        slam.final_bundle_adjustment(args.final_ba_window_size,
                                     args.final_ba_window_stride)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings["final_ba_s"] = time.perf_counter() - t0
        timings["final_ba_iterations"] = slam.direct_ba.iterations_run[calls:]
        if not args.quiet:
            print(f"final BA in {timings['final_ba_s']:.2f} s")

    if args.export_poses:
        slam.export_trajectory(args.export_poses)
        print(f"poses written to {args.export_poses}")
    if args.export_point_cloud:
        slam.export_point_cloud(args.export_point_cloud)
        print(f"point cloud written to {args.export_point_cloud}")
    if args.save_state:
        t0 = time.perf_counter()
        state.save_state(slam, args.save_state)
        timings["save_state_s"] = time.perf_counter() - t0
        print(f"state written to {args.save_state}")
    if args.export_calibration:
        state.save_calibration(slam.cam, slam.direct_ba.depth_params,
                               args.export_calibration)
    if args.export_frame_times:
        ba = slam.direct_ba
        with open(args.export_frame_times, "w") as f:
            json.dump({"device": str(device),
                       "frame_ms": [[i, ms] for i, ms in slam.frame_times_ms],
                       "keyframe_frames": slam.keyframe_frames,
                       "ba_drain_frames": slam.ba_drain_frames,
                       "self_calibration_frames": slam.self_calibration_frames,
                       "loop_closures": slam.loop_closure_count,
                       "closure_attempts": slam.closure_attempts,
                       "ba_iterations": ba.iterations_run,
                       "cg_steps": ba.cg_steps,
                       "intrinsics_step_ms": ba.intrinsics_spans.ms(),
                       "pcg_iteration_ms": ba.pcg_spans.ms(),
                       "keyframes": ba.keyframes.live_count,
                       "surfels": ba.surfel_count, **timings}, f)
    if not args.quiet:
        ms = sorted(ms for _, ms in slam.frame_times_ms[1:])
        if ms:
            print(f"{len(slam.frame_times_ms)} frames on {device}, median "
                  f"{ms[len(ms) // 2]:.2f} ms per frame after the first")
    return slam


if __name__ == "__main__":
    sys.exit(main())
