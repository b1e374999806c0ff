"""Command-line entry point of the port.

Run as

    python -m badslam_torch <dataset_dir> --device cuda \\
        --export_point_cloud map.ply \\
        [--final_ba] [--save_state s.npz | --load_state s.npz] \\
        [--optimize_intrinsics true --export_calibration calib] \\
        [--use_pcg true --parallel_ba false] [--export_viewer map.html]
    python -m badslam_torch --live dir:<path> | --live tcp:<port> \\
        [--live_viewer_dir view --live_viewer_port 8765]

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
flight are applied before the final BA. ``--live`` consumes a live stream
instead of a dataset (``dir:<path>``: a directory a camera process drops
PNG pairs into; ``tcp:<port>``: a binary frame stream; the vendor SDK
inputs raise without their SDK); a live stream cannot be resumed from a
snapshot, so ``--load_state`` is refused with it. ``--export_viewer``
writes a self-contained HTML map viewer after the run;
``--live_viewer_dir`` serves a map view during the run (a snapshot every
``--live_viewer_interval`` keyframes, each a device read) with run, pause,
step and command buttons. ``--n_devices N`` runs BA over a mesh of N
shards: cuda:0..N-1 with ``--device cuda`` (it raises when fewer cards are
visible), N shards on the one CPU with ``--device cpu``; the planes are
streamed instead of replicated above ``--plane_replication_budget_mb``
(0 forces streaming). ``--save_timings PATH`` writes the JAX package's
per-BA-call timing rows (per-stage rows with ``--sync_stage_profiling
true``, each stage ended by a device synchronization);
``--export_final_timings PATH`` writes the timer report, which a run
without ``--quiet`` also prints, with the device memory line. Times are
the card's (CUDA events) with ``--device cuda``. ``--autotune`` times the
bilateral kernel's tile shapes on the card at the run's depth size before
the frame loop and persists the fastest per card and size
(``ops.autotune``); later runs launch it. On the CPU it tunes nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from badslam_torch.config import BadSlamConfig


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="badslam_torch",
        description="Direct RGB-D SLAM in PyTorch + CUDA",
    )
    p.add_argument("dataset", nargs="?", default=None,
                   help="TUM/ETH3D-format dataset directory (omit with --live)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda, cuda:N or cpu "
                        "(cuda fails when CUDA is not available)")
    p.add_argument("--trajectory_filename", default=None,
                   help="optional ground-truth/init trajectory in the dataset dir")
    p.add_argument("--live", default=None,
                   help="live input instead of a dataset: 'dir:<path>' "
                        "(follow a frame-drop directory), 'tcp:<port>' "
                        "(binary frame stream), or 'realsense'/'k4a'/"
                        "'structure' (vendor SDK required)")
    p.add_argument("--live_max_frames", type=int, default=10000,
                   help="capacity of the live-mode trajectory buffers")

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
    p.add_argument("--export_final_timings", default=None,
                   help="write the timing report to this path")
    p.add_argument("--save_timings", default=None,
                   help="stream per-BA-run timing rows to this file (the "
                        "JAX package's rows; combine with "
                        "--sync_stage_profiling true for per-stage rows)")
    p.add_argument("--export_frame_times", default=None,
                   help="write per-frame times (ms; CUDA events on a GPU), the "
                        "keyframe frames, the frames that drained queued BA "
                        "iterations, the keyframe frames that self-"
                        "calibrated, the loop closures and closure attempts, "
                        "the iterations of each BA call, the CG "
                        "steps of each PCG outer iteration, the ms of each "
                        "intrinsics step and PCG outer iteration, the final "
                        "keyframe and surfel counts, with --live each "
                        "frame's capture-to-pose lag (ms) and backlog "
                        "(frames) and, where they ran, the seconds of the "
                        "final BA (and its calls' iterations), of "
                        "--load_state, --save_state and --export_viewer as "
                        "JSON to this path")
    p.add_argument("--profile", default=None,
                   help="profile the run with torch.profiler and write "
                        "key_averages.txt and profile_summary.json (spans, "
                        "kernels run on the device, graph replays included, "
                        "host launches, device time) into this directory, "
                        "and on a card graph_replays.json (each graph replay "
                        "as a Chrome-trace event on the profiler's clock)")
    p.add_argument("--save_state", default=None,
                   help="write a full state snapshot (.npz) after the run")
    p.add_argument("--load_state", default=None,
                   help="resume from a state snapshot (of either package) "
                        "before processing; the snapshot's config is used")
    p.add_argument("--export_calibration", default=None,
                   help="write calibration text files with this prefix")
    p.add_argument("--export_viewer", default=None,
                   help="write a self-contained HTML map viewer to this path")
    p.add_argument("--live_viewer_dir", default=None,
                   help="serve a live map view from this directory (a "
                        "snapshot every --live_viewer_interval keyframes; "
                        "each snapshot is a device read and sync: do not "
                        "time runs with this on)")
    p.add_argument("--live_viewer_port", type=int, default=8765,
                   help="HTTP port for --live_viewer_dir (0 = any free port)")
    p.add_argument("--live_viewer_interval", type=int, default=5,
                   help="keyframes between live-viewer snapshots")
    p.add_argument("--final_ba", action="store_true",
                   help="run windowed + global final BA after the frame loop")
    p.add_argument("--final_ba_window_size", type=int, default=16)
    p.add_argument("--final_ba_window_stride", type=int, default=8)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--autotune", action="store_true",
                   help="tune kernel parameters for this dataset's image "
                        "size before running (persisted per card; one-time "
                        "cost; nothing to tune with --device cpu)")
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


def _profiled_run(slam, out_dir: str, run_frames) -> None:
    """run_frames() (slam.run or slam.run_live) under torch.profiler;
    writes the key_averages table and a JSON summary: per span (upload,
    steady_frame, preprocess, pyramid, track, duel, gn_iteration/width<W>,
    ba, ba_drain, the BA stages ba/<stage>, trajectory_deformation,
    loop_drain_wait, loop_closure_attempt) its count and host ms; the
    kernels the card ran (``kernel_launches``: every kernel execution the
    profiler saw on the device, those of CUDA-graph replays included, so a
    steady frame's graph counts its kernel nodes that ran, not its capture)
    and their device ms; the kernel launches made from the host
    (``host_kernel_launches``) and the graph replays (``graph_replays``);
    the host-side synchronizations; and each capture of the steady frame
    (``steady_graph_captures``: seconds, nodes, memory). On a card,
    ``graph_replays.json`` holds the replays of the run's graphs
    (``BadSlam.device_timeline``) as a Chrome trace, a track per graph, with
    "ts" in microseconds since the epoch on the profiler's host clock (the
    profiler's own trace counts from its "baseTimeNanoseconds")."""
    import os
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from badslam_torch.utils.timing import PROFILER_CLOCK

    activities = [ProfilerActivity.CPU]
    if slam.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    start_ns = time.clock_gettime_ns(PROFILER_CLOCK)
    with profile(activities=activities) as prof:
        run_frames()
        if slam.device.type == "cuda":
            torch.cuda.synchronize(slam.device)
    wall_ms = 1000.0 * (time.perf_counter() - t0)
    replays = [r for r in slam.device_timeline() if r["start_ns"] >= start_ns]

    events = prof.key_averages()
    # A span appears twice: as a host event and as a device annotation.
    spans = {e.key: {"count": e.count, "host_ms": e.cpu_time_total / 1000.0}
             for e in events
             if e.device_type.name == "CPU"
             and (e.key in ("upload", "steady_frame", "preprocess", "pyramid", "track",
                            "duel",
                            "ba", "ba_drain", "trajectory_deformation",
                            "loop_drain_wait", "loop_closure_attempt")
                  or e.key.startswith(("gn_iteration/", "ba/", "capture/")))}
    kernels = [e for e in events
               if e.device_type.name == "CUDA" and not e.is_user_annotation]
    syncs = sum(e.count for e in events
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                             "cudaEventSynchronize", "cudaMemcpyAsync"))
    device_ms = sum(e.self_device_time_total for e in kernels) / 1000.0
    host_launches = sum(e.count for e in events
                        if e.device_type.name == "CPU"
                        and e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                      "cuLaunchKernel", "cuLaunchKernelEx"))
    summary = {
        "device": str(slam.device),
        "frames": len(slam.frame_times_ms),
        "wall_ms": wall_ms,
        "spans": spans,
        "kernel_launches": sum(e.count for e in kernels),
        "kernel_device_ms": device_ms,
        "host_kernel_launches": host_launches,
        "graph_replays": sum(e.count for e in events if e.key == "cudaGraphLaunch"),
        "steady_graph_captures": (slam.steady_graph.captures
                                  if getattr(slam, "steady_graph", None) is not None else []),
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
    if replays:
        tracks = {name: i for i, name in enumerate(dict.fromkeys(r["graph"] for r in replays))}
        events = [{"name": "thread_name", "ph": "M", "pid": "graph replays", "tid": i,
                   "args": {"name": name}} for name, i in tracks.items()]
        events += [{"name": r["graph"], "cat": "graph_replay", "ph": "X",
                    "pid": "graph replays", "tid": tracks[r["graph"]],
                    "ts": r["start_ns"] / 1e3, "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
                    "args": {"frame": r["frame"]}} for r in replays]
        with open(os.path.join(out_dir, "graph_replays.json"), "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ns"}, f)


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None, mesh=None):
    """What `main` does; returns the BadSlam after its run and exports.
    `mesh` (a parallel.Mesh of --n_devices shards) overrides the mesh that
    --n_devices would build, e.g. to put several shards on one card."""
    args = build_parser().parse_args(argv)
    if args.live and args.load_state:
        raise ValueError("--load_state cannot resume a --live stream: a snapshot "
                         "needs the frames before it, which a live stream does not "
                         "keep")
    if not (args.dataset or args.live):
        build_parser().error("either a dataset directory or --live is required")
    config = config_from_args(args)

    from badslam_torch.frontend import BadSlam, check_supported
    from badslam_torch.io import state
    from badslam_torch.io.dataset import load_tum_dataset
    from badslam_torch.io.live_inputs import open_live_input
    from badslam_torch.utils.memory import format_memory_usage
    from badslam_torch.utils.timing import Timing
    from badslam_torch.viz.viewer import LiveViewer

    if not args.load_state:  # a resumed run takes the snapshot's config
        check_supported(config)
    device = resolve_device(args.device)
    live_input = open_live_input(args.live, config) if args.live else None
    viewer = None
    timings_file = None
    timings = {}
    # The registry is process-wide: a second run in one process reports
    # only its own regions.
    Timing.reset()
    try:
        if live_input is not None:
            video = live_input.start(max_frames=args.live_max_frames,
                                     depth_scaling=1.0 / config.raw_to_float_depth)
        else:
            video = load_tum_dataset(args.dataset, args.trajectory_filename)
        if args.autotune:
            from badslam_torch.ops.kernels import autotune_preprocess

            lvl = 2 ** config.pyramid_level_for_depth
            autotune_preprocess(video.camera.height // lvl,
                                video.camera.width // lvl,
                                max_depth=config.max_depth, device=device)
        if args.load_state:
            t0 = time.perf_counter()
            slam = state.load_state(args.load_state, video, device)
            timings["load_state_s"] = time.perf_counter() - t0
            start = slam.last_frame_index + 1
        else:
            slam = BadSlam(config, video, device, mesh=mesh)
            start = None
        if args.save_timings:
            timings_file = open(args.save_timings, "w")
            slam.direct_ba.set_save_timings(timings_file)
        if args.live_viewer_dir:
            viewer = LiveViewer(args.live_viewer_dir, port=args.live_viewer_port,
                                interval=args.live_viewer_interval)
            slam.live_viewer = viewer
            print(f"live viewer: http://127.0.0.1:{viewer.port}/index.html")

        def run_frames():
            if live_input is not None:
                slam.run_live(progress=not args.quiet)
            else:
                slam.run(start=start, progress=not args.quiet)

        try:
            if args.profile:
                _profiled_run(slam, args.profile, run_frames)
            else:
                run_frames()
        finally:
            slam.close()
        _finish(slam, args, device, timings)
    finally:
        if live_input is not None:
            live_input.stop()
        if viewer is not None:
            viewer.close()
        if timings_file is not None:
            timings_file.close()
    if args.export_final_timings:
        Timing.save(args.export_final_timings)
    if not args.quiet:
        print(Timing.report())
        print(format_memory_usage(device))  # PrintGPUMemoryUsage analog
    return slam


def _finish(slam, args, device, timings: dict) -> None:
    """After the frame loop: the final BA, the exports, the live viewer's
    last snapshot and the summary line."""
    import torch

    from badslam_torch.io import state
    from badslam_torch.viz.viewer import export_html_viewer

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
    if args.export_viewer:
        t0 = time.perf_counter()
        export_html_viewer(slam, args.export_viewer)
        timings["export_viewer_s"] = time.perf_counter() - t0
        print(f"viewer written to {args.export_viewer}")
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
                       "ba_call_ms": ba.ba_spans.ms(),
                       "keyframes": ba.keyframes.live_count,
                       "surfels": ba.surfel_count,
                       "live_lag_ms": [[i, 1000.0 * s] for i, s in slam.live_lag_s],
                       "live_backlog": slam.live_backlog, **timings}, f)
    if not args.quiet:
        ms = sorted(ms for _, ms in slam.frame_times_ms[1:])
        if ms:
            print(f"{len(slam.frame_times_ms)} frames on {device}, median "
                  f"{ms[len(ms) // 2]:.2f} ms per frame after the first")
    if slam.live_viewer is not None:
        slam.live_viewer.snapshot(slam)  # the final state


if __name__ == "__main__":
    sys.exit(main())
