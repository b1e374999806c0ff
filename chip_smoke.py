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
   67x160, on a rendered 480x640 frame (the slice's input) and on frame 0
   of phase 8's distorted input after undistortion and one median pass
   (502x670, a ragged row length), atol 1e-5, each with its grid's
   registers, spills and waves, and at radius 0 (the launch, staging and
   stores alone); K2 (image gather) on the probe's 480x640 field and
   batched [4, 480, 640] x [4, 200000], int32 and int64 indices, with
   out-of-range and negative flat indices, exact (NaN where the plain
   version gives NaN), and at the undistortion's shapes on that frame
   (nearest depth [1, 480, 640] x [1, 336340], the four bilinear color
   taps [3, 480, 640] x [3, 336340]), exact; K3 (one-hot gather) at
   480x640, exact; H2 (BA's pose accumulation) at the benchmark's
   scale, 8 keyframes of 640x480 planes against 1,048,576 surfel rows 10%
   live: counts exact, H and b to 1e-4 of each keyframe's largest entry,
   two launches bit for bit, and the device time of the whole step
   (`surfel_pose_coeffs`, with the pose inverse and rotation in PyTorch)
   beside the kernel's; H1 (the tracker's Gauss-Newton step) on a rendered
   pair at 480x640 and at its coarsest level, 30x40, depth and descriptor
   residuals: counts exact, H and b to 1e-5 of the largest entry, two
   launches bit for bit, and the device time of the whole step (both
   kernels) beside the coefficient kernel's and the plain chain's
   accumulation and step. For each: max abs error,
   device time per call (a CUDA graph of 50 calls), eager call latency,
   the plain version's device time, the least time the card could take
   (bytes over 3.35 TB/s or operations over 67 TFLOP/s, whichever is
   larger) and, for K2 and K3, the device time of `torch.take`.
4. The probe path: `badslam_torch.probe_gather.main()` (K2, K3, the
   library gather and the tracker's accumulation at VGA), its JSON line.
5. The slice (the main path with loop detection off): 30 frames of
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
   Phase steady, after the slice: every SLAM phase runs the steady frame
   (each tracked frame at input level 0) as one replay of a captured CUDA
   graph, the Gauss-Newton early exit in WHILE nodes, and the frames between
   two keyframes as one chunk of replays. This phase runs the slice's
   frames through BadSlam.run once with the graphs and once with the eager
   call of the same steady-frame function and its host-read loop, in this
   process: poses equal (max |dq|, |dt| within 1e-6), K1 once per frame and
   the same K2 and H1 launches and Gauss-Newton iterations in both, every steady
   frame replayed, chunks run; prints the steady-frame, keyframe and
   BA-drain medians of each, GN iterations per frame, launches, peak memory,
   each graph's capture and instantiate seconds, nodes and pool memory;
   then on each path the slice with BA off: frames 11-19 as a chunk, timed
   (the host's wall time, the card's span between CUDA events, with graphs
   the kernel nodes the card ran), and frames 21-23 as a chunk under
   torch.profiler (kernels and kernel time as it sees them, host launches,
   graph replays), per frame.
   Phase ba_graph, after steady: every BA call that the JAX package runs as
   its fused program (the keyframe calls and the drains) is one replay of a
   captured CUDA graph per call (badslam_torch/ba/graph.py), its loops WHILE
   nodes. This phase runs the slice's frames through BadSlam.run once with
   the BA graphs and once with `ba_graph = None` (the same function with
   host loops), in this process: poses equal (max |dq|, |dt| within 1e-6),
   the same BA iterations per call (the device counter), surfels and K2
   launches, K1 once per frame, every call replayed; then three more drain
   calls on each finished state, device ms per call (the first, a capture,
   dropped); then frames 0-20 with `--sync_surfel_bucket false` and a
   replayed drain and keyframe call, each with its trajectory deformation,
   under torch.cuda.set_sync_debug_mode("error"). Prints the keyframe,
   drain and steady medians, BA ms per call, iterations, surfels, launches,
   replays, peak memory, and per graph its capture and instantiate seconds,
   nodes, WHILE nodes and pool memory. The loop phase also prints its BA
   graphs' captures, buckets, replays and keyframe-frame median.
6. The odometry path: the first 10 frames with BA off; K1 once per frame,
   ATE below 1e-3 m.
7. The card against the CPU: a 160x120, 13-frame BA sequence on both
   devices (poses to 1e-4, surfel counts within 1%), and the first 6 VGA
   odometry frames on the CPU against the CUDA run (poses to 1e-4).
8. The distorted raw input path: 20 VGA frames rendered through a
   radial-tangential camera (k1 -0.08, k2 0.01) and written as a raw TUM
   download (rgb.txt/depth.txt only, depth stamps 7 ms late, one depth
   frame dropped), through `cli.main` on cuda with one median pass, BA (10
   iterations per keyframe, a keyframe every 10 frames) and the final BA.
   Checks the decided 670x502 pinhole, K1 once per frame at that size, K2
   launched, final-BA iterations, ATE below 3e-3 m; prints per-frame
   medians, the device ms per frame of undistortion plus median (CUDA
   graph) and the final BA's seconds. The sequence is written before
   phase 3, which reads its frame 0.
9. The input pyramid: 10 frames of a 1280x960 source processed at 640x480
   (level 1), BA on; ATE below 1e-3 m, K1 launched at 640x480 per frame.
10. Resume: the slice's sequence run to frame 10 with `--save_state`, then
   resumed with `--load_state`; poses held to the continuous slice run at
   1e-4; prints the snapshot's bytes and the save and load seconds.
11. The card against the CPU on the new path: a 96x72 radtan sequence with
   two median passes, BA and the final BA on both devices (poses to 1e-4,
   surfel counts within 1%).
12. Self-calibration (path a): 24 VGA frames rendered with the true camera
   while calibration.txt holds a perturbed one (fx x 1.005, cx + 1 px,
   cy - 1 px), a keyframe every 2 frames (12 keyframes: three BA calls
   pass the gate of >= 10), parallel BA with 10 iterations per keyframe and
   --optimize_intrinsics. Checks the intrinsics step ran, the camera
   changed, poses and the calibration are finite, K2 launched, the ATE is
   below its limit; prints the intrinsics error before and after, the ATE,
   per-frame medians (self-calibrating keyframe frames apart), ms per
   intrinsics step, peak memory and launches.
13. PCG (paths b + c): the same sequence with --use_pcg true --parallel_ba
   false, 5 outer iterations per keyframe, and --final_ba. Checks PCG outer iterations and CG steps ran,
   finite poses and calibration, K2 launched, the ATE; prints the CG steps
   per outer iteration, ms per outer iteration (at keyframes and in the
   final pass), the final pass's seconds, peak memory, launches, and the
   device time, K2 launches and kernel launches of one matrix-free product
   A p at the run's end (all keyframes).
14. The card against the CPU on the new paths: a 96x72, 22-frame
   miscalibrated sequence (11 keyframes) through paths (a) and (b) on both
   devices: poses to 1e-4, calibrated fx..cy to 1e-5 relative, surfel
   counts within 1%.
15. Loop closure (the default main path): tests/test_loop_organic.py's
   fixture at 640x480 (a textured box room, a 0.4 m circle closed after
   150 of 170 frames, depth noise, a quadratic depth bias, gray-level
   noise), written once, through `cli.run` on cuda with 5 scales, detection
   images at 640x480, `--loop_detection_image_frequency 0.3`, no pacing and
   the default config otherwise (loop detection on the worker thread,
   parallel BA, a keyframe every 10 frames), and with loop detection off.
   A child process started after phase 4 writes the sequence and makes the
   run with loop detection off through `cli.main` while phases 5-14 run
   (their times include its share of the host and the card); this phase
   waits for it and makes the run with loop detection on alone. Checks the JAX test's asserts (a closure, none applied by frame 149,
   ATE on below 0.66 x ATE off, endpoint error below 0.6 m), K1 once per
   frame, H1 launched in the closure's refinement, every attempt that
   reached the gates a run of its CUDA graph (loop/graph.py: a capture or
   a replay); prints the frames the closures applied at, the attempts and
   each gate's rejections, features per keyframe, the worker's ms per
   keyframe and per stage, the drain's waits, per closure attempt whether
   it captured or replayed, its ms between CUDA events, its H1 launches
   (from the graph's device counters) and its gates (read after the run),
   each closure graph's capture record, per-frame medians (keyframe frames
   with a closure attempt apart), both ATEs and peak memory; then the
   first attempt again on the finished state, restored before each call:
   device ms of two replays against two eager calls, alternating. The
   kernels line's K1 and K2 launches are the run's.
16. The card against the CPU on loop closure: test_loop.py:211's injected
   candidate at 128x96 (16 frames, BA off, drift injected into the last
   keyframe) on both devices, the card's attempts graph runs: keyframe
   poses and the trajectory to 1e-4, one closure on each, the drift more
   than halved, and a candidate the necessity gate rejects leaving every
   pose bit-identical on both.
   Phase closure_graph, after it: the same candidate on the card, on one
   state, rejected and accepted in turn, each as a replay of the attempt's
   graph and as the eager call of the same function with the host loop:
   keyframe poses and trajectory max |dq|, |dt| <= 1e-6, the same gates and
   H1 launches, a replayed rejection bit-identical; a replayed accepting
   and rejecting attempt under set_sync_debug_mode("error"); prints the
   graph's capture and instantiate seconds, nodes, kernel nodes, WHILE
   nodes and pool memory, and device ms per replay against per eager call.
17. Live input from a directory (the live path): the slice's 30 VGA
   frames (PNGs written by io/png.py) dropped into a directory at 30 FPS
   by a writer thread while `cli.run --live dir:` follows it on cuda with
   the live viewer (a snapshot per keyframe, HTTP on a free port) and the
   HTML export. Checks every frame processed, K1 once per frame at
   480x640, K2 launched, ATE below 1e-3 m, a snapshot per keyframe plus
   the final one, the HTML above 10 kB with "kf_poses"; prints per-frame
   medians, the capture-to-pose lag (median, p90, max), the largest
   backlog, PNG decode ms per VGA depth and color frame with the decoder
   that served, ms per snapshot, peak memory and launches.
18. Live input over TCP: the same frames sent with `send_frame` at 30 FPS
   to `cli.run --live tcp:<port>`; poses held to phase 17's at 1e-4.
19. Viewer controls on the card: on phase 17's finished state, `ba`,
   `densify`, `set:`, `move_kf:` and `delete_kf:` sent over HTTP /control
   to a LiveViewer on a free port and applied by the front end; checks
   each effect, and that deleting the base keyframe and malformed commands
   change nothing; prints each command's ms.
20. The card against the CPU on a live stream: phase 7's 160x120, 13-frame
   sequence as a finished directory stream on both devices (poses to
   1e-4, surfel counts within 1%).
21. The vendor-SDK inputs: RealSense, Azure Kinect and Structure Core each
   refuse to start without their SDK (RuntimeError).
22. Multi-device BA (multi): the slice's sequence and flags through
   `cli.run` with `--n_devices 2` on a 2-shard mesh (cuda:0 and cuda:1
   when two cards are visible, else both shards on cuda:0; it prints
   which), once with the planes replicated (integrated) and once streamed
   (`--plane_replication_budget_mb 0`). Each is held to the single-device
   slice of this call: poses to 1e-4, equal surfel counts, K1 once per
   frame and K2 launched by both shards' work; with both shards on cuda:0
   every BA call is a replay of its CUDA graph over the mesh
   (badslam_torch/ba/graph.py; with two cards the calls run eagerly, the
   logged route); prints the ATE, per-frame medians, BA ms per call (and
   the slice's), K2 launches per shard, the plane bytes each shard holds,
   peak memory per card and each graph's capture and instantiate seconds,
   nodes, WHILE nodes, pool memory and replays. Then
   `parallel.dryrun.dryrun_multichip(4)` on four shards of cuda:0.
   Phase mesh_graph, after it: on each layout's finished state, drain calls
   of 2 iterations over the mesh as replays of their graph against the
   eager call of the same function (host loops), alternating from one
   restored state for 3 rounds: poses max |dq|, |dt| <= 1e-6, the same
   iterations, surfels and K2, H2 and H3 launches per shard (both shards
   launching); then a replayed drain
   under set_sync_debug_mode("error"); prints device ms per replay and per
   eager call (CUDA events).
23. The card against the CPU on the mesh (cpu_multi): phase 7's 160x120,
   13-frame sequence with a 2-shard mesh on the card and a 2-shard mesh on
   the CPU, integrated and streamed (poses to 1e-4, surfel counts within
   1%).
24. Timing rows (timings): the slice's sequence and flags through
   `cli.run` with `--save_timings` and `--export_final_timings`, once with
   `--sync_stage_profiling true` (every BA stage ended by a device sync,
   every BA iteration run) and once without. Parses both row files (a row
   out of place fails) and prints the per-stage device ms (the median over
   BA calls of each stage's ms in the call, and the median of its rows),
   each call's stage sum against its `ba_call_ms` (a sum above it by more
   than 1 ms fails), the fused rows' `sync_ms`, both runs' per-frame
   medians and timer totals, the device ATE (`ate_rmse_device` on the card
   against the host `ate_rmse`, 1e-6 relative) and `evaluate_ate` on the
   exported poses. Holds the unflagged run to the slice (poses to 1e-4),
   the flagged run to an ATE limit of 1.5e-4 m (its every-iteration BA moves
   poses by more than 1e-4; the gap is printed), and the staged path on the
   card against the CPU on phase 7's 160x120 sequence (poses to 1e-4, the
   same row keys).
25. Autotune (autotune): K1 with each tile of its table
   (`kernels.bilateral_tiles()`: the default 8x2 first, then 8x1) at VGA:
   the device time per call (CUDA graph of 50, median of 5), registers,
   occupancy and waves; on phase 3's four K1 inputs every tile bit for bit
   equal to the default tile and within 1e-5 of the plain version. Each
   tile's device time at each K1 size the script drives (`TILE_SIZES`).
   Then the odometry phase's run and phase 7's 160x120 run with
   `--autotune`, each against a store of its own (every other phase reads
   an empty store, so K1 takes the default tile there): the store holds
   `bilateral_<H>x<W>` under the card's name, K1's frame launches took the
   stored tile (the tuning's 1 + 10 launches per tile apart), the poses
   equal the unflagged runs' (to 1e-4; the gap is printed); prints the
   tuner's ms per tile and the VGA winner against the default. Last, the
   odometry run against a store holding the tile the VGA tuning did not
   keep: all 10 frames take it, with the same poses.
26. The nvidia-smi line again, one JSON line of the kernels, then the last
   line {"ok": true, "device": {...}}. Launches are exact under graph
   replay (badslam_torch/ops/kernels.py): the counts a run reports are
   those of the kernels the card ran.

Each of phases 8-25 prints the card's name and power limit beside its
numbers. Every phase before 25 launches K1 with its default tile, and the
slice, input, pyramid and live phases check so.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

import numpy as np
import torch

from badslam_torch import cli, probe_gather, synthetic
from badslam_torch.ba import geometry_opt as geo
from badslam_torch.ba import pose_opt
from badslam_torch.ba.pcg import PCGSystem
from badslam_torch.config import BadSlamConfig
from badslam_torch.cuda_timing import call_ms, device_ms
from badslam_torch.frontend import BadSlam
from badslam_torch.geometry import se3
from badslam_torch.geometry import se3_np as s3
from badslam_torch.geometry.camera import PinholeCamera
from badslam_torch.io import live_inputs, native_loader
from badslam_torch.io.dataset import (
    _imread_color,
    _imread_depth,
    load_tum_dataset,
    load_tum_trajectory,
)
from badslam_torch.io.state import load_calibration
from badslam_torch.loop.thread import LoopDetectionThread
from badslam_torch.mapping.keyframes import KeyframeStack
from badslam_torch.ops import autotune as tuner
from badslam_torch.ops import interp, kernels
from badslam_torch.parallel import make_mesh
from badslam_torch.parallel.dryrun import dryrun_multichip
from badslam_torch.tools import evaluate_ate
from badslam_torch.ops.interp import gather_nearest_plain, gather_onehot_plain
from badslam_torch.tracking import pairwise
from badslam_torch.utils.timing import Timing
from badslam_torch.ops.preprocess import (
    bilateral_filter_and_cutoff,
    median_filter_and_densify,
    shift2d,
    undistort_image,
)
from badslam_torch.viz.viewer import LiveViewer

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
# The distorted raw input: a TUM-like VGA camera through k1 -0.08, k2 0.01,
# whose covering pinhole is 670x502; the depth frame INPUT_DROP is dropped.
INPUT_FRAMES, INPUT_DROP, INPUT_SIZE = 20, 7, (502, 670)
INPUT_CAMERA = PinholeCamera(fx=525.0, fy=525.0, cx=320.0, cy=240.0,
                             width=WIDTH, height=HEIGHT)
INPUT_DISTORTION = (-0.08, 0.01)
# The JAX package's own CLI ends at 2.13e-3 m on this input, 8.0e-4 m
# without the median pass (`reference_ate_of_chip_smoke_input` in
# tests/test_torch_input.py, on the CPU), above tests/test_modes.py's
# 2e-3 for 96x72 without the median; so this input is held at 3e-3.
INPUT_ATE_LIMIT_M = 3e-3
INPUT_FLAGS = ["--num_scales", "5", "--keyframe_interval", "10",
               "--max_num_ba_iterations_per_keyframe", "10",
               "--median_filter_and_densify_iterations", "1", "--final_ba",
               "--enable_loop_detection", "false", "--fps_restriction", "0",
               "--quiet"]
PYRAMID_FRAMES = 10
PYRAMID_FLAGS = ["--num_scales", "5", "--keyframe_interval", "5",
                 "--max_num_ba_iterations_per_keyframe", "10",
                 "--pyramid_level_for_depth", "1", "--pyramid_level_for_color", "1",
                 "--enable_loop_detection", "false", "--fps_restriction", "0",
                 "--quiet"]
RESUME_AFTER = 10  # the last frame of the first half: a keyframe, BA queued
SMALL_INPUT_FRAMES = 8
SMALL_INPUT_FLAGS = ["--num_scales", "3", "--keyframe_interval", "3",
                     "--max_num_ba_iterations_per_keyframe", "4",
                     "--median_filter_and_densify_iterations", "2", "--final_ba",
                     "--final_ba_window_size", "2", "--final_ba_window_stride", "1",
                     "--max_surfel_count", str(1 << 13),
                     "--enable_loop_detection", "false", "--fps_restriction", "0",
                     "--quiet"]
# Self-calibration: 24 VGA frames, a keyframe every 2 (12 keyframes, so
# three BA calls pass the gate of >= 10 keyframes), rendered with the true
# camera while calibration.txt holds fx x 1.005, cx + 1 px, cy - 1 px.
CALIB_FRAMES = 24
CALIB_PERTURBATION = (1.005, 1.0, -1.0)
CALIB_FLAGS = ["--num_scales", "5", "--keyframe_interval", "2",
               "--max_num_ba_iterations_per_keyframe", "10",
               "--optimize_intrinsics", "true",
               "--enable_loop_detection", "false", "--fps_restriction", "0",
               "--quiet"]
# PCG: 5 outer iterations per keyframe (it was 10; cut to make room for
# the loop phase), 10 in the final pass.
PCG_FLAGS = CALIB_FLAGS + ["--use_pcg", "true", "--parallel_ba", "false", "--final_ba",
                           "--max_num_ba_iterations_per_keyframe", "5"]
# ATE limits of the two self-calibrating VGA runs; see
# `reference_ate_of_chip_smoke_calibration` in
# tests/test_torch_calibration_slice.py for the JAX CLI's own ATE on this
# sequence (on the CPU, at a reduced size).
CALIB_ATE_LIMIT_M = 3e-3
PCG_ATE_LIMIT_M = 3e-3
# The card against the CPU on the new paths: 96x72, 22 frames (11
# keyframes), 2 alternating iterations or 1 PCG outer iteration per
# keyframe; poses to 1e-4, the calibrated fx..cy to 1e-5 relative. The
# PCG path's CG stops can differ between the two (its stopping rule is
# decided by rounding where the residual norm is not monotone), which
# on the CPU against the JAX package moves poses by up to 4.5e-4 m
# (tests/test_torch_calibration_slice.py); here the card and the CPU
# stayed within 3.6e-5 m and 3.5e-6 relative on an H100 (PERF.md).
SMALL_CALIB_FRAMES = 22
SMALL_CALIB_FLAGS = ["--num_scales", "3", "--keyframe_interval", "2",
                     "--max_num_ba_iterations_per_keyframe", "2",
                     "--optimize_intrinsics", "true", "--max_surfel_count", str(1 << 14),
                     "--enable_loop_detection", "false", "--fps_restriction", "0",
                     "--quiet"]
SMALL_PCG_FLAGS = SMALL_CALIB_FLAGS + ["--use_pcg", "true", "--parallel_ba", "false",
                                       "--max_num_ba_iterations_per_keyframe", "1"]
CALIB_CAM_RTOL = 1e-5
# Loop closure: tests/test_loop_organic.py's fixture at 640x480 (a textured
# box room, a 0.4 m circle closed after 150 frames, 170 frames, sensor
# noise and a quadratic depth bias), the default config otherwise, and its
# asserts: closures >= 1, none applied by frame 149, ATE(on) < 0.66 x
# ATE(off), endpoint translation error < 0.6 m.
LOOP_FRAMES, LOOP_AT = 170, 150
LOOP_FLAGS = ["--num_scales", "5", "--max_depth", "3.5",
              "--loop_detection_image_frequency", "0.3",
              "--loop_detection_images_width", str(WIDTH),
              "--loop_detection_images_height", str(HEIGHT),
              "--fps_restriction", "0", "--quiet"]
LOOP_ATE_RATIO, LOOP_ENDPOINT_M = 0.66, 0.6
# The card against the CPU on loop closure: tests/test_loop.py:211's
# injected candidate (128x96, 16 frames, 3 scales, a keyframe every 4, BA
# off, the same drift on the last keyframe).
CPU_LOOP_CONFIG = dict(num_scales=3, max_surfel_count=1 << 13, keyframe_interval=4,
                       max_num_ba_iterations_per_keyframe=0, fps_restriction=0)
CPU_LOOP_DRIFT = synthetic.pose(tx=0.004, ty=-0.003, rz=0.002)
# The card's name and power limit, as nvidia-smi gives them (phase_device).
SMI = ""


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
    global SMI
    SMI = _smi()
    print(SMI)  # the card's name and power limit, as nvidia-smi gives them
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


def _k1_launch(h: int, w: int, radius: int, tile=None) -> str:
    """K1's grid against the card: registers and local (spill) bytes per
    thread, blocks resident per SM, occupancy (resident threads over the
    SM's most), waves (blocks over SMs x resident blocks) and the balance
    over SMs (mean over most blocks per SM)."""
    i = kernels.bilateral_launch_info(h, w, radius, tile)
    blocks = i["grid_x"] * i["grid_y"]
    waves = blocks / (i["sms"] * i["blocks_per_sm"])
    balance = blocks / (i["sms"] * -(-blocks // i["sms"]))
    occupancy = i["blocks_per_sm"] * i["threads"] / i["sm_threads"]
    return (f"grid {i['grid_x']}x{i['grid_y']} = {blocks} blocks of {i['threads']} "
            f"threads, {i['shared_bytes']} B shared, {i['registers']} registers, "
            f"{i['local_bytes']} B local (spills) per thread, {i['blocks_per_sm']} "
            f"blocks resident per SM on {i['sms']} SMs (occupancy {occupancy:.3f}): "
            f"{waves:.3f} waves, balance {balance:.3f}")


def _input_frame(data: str):
    """Frame 0 of the distorted raw input as the input phase's path gives
    it to the card: (loaded video, undistortion map, metric depth and u8
    color of the source)."""
    video = load_tum_dataset(data)
    umap = torch.from_numpy(video.undistortion_map).cuda()
    depth = torch.from_numpy(video.depth_u16(0).astype(np.int32)).cuda()
    rgb = torch.from_numpy(video.color_u8(0)).cuda()
    return video, umap, depth.to(torch.float32) * (1.0 / 5000.0), rgb


def _undistorted_frame(input_data: str) -> torch.Tensor:
    """Frame 0 of the distorted input after undistortion and one median
    pass, on the card."""
    _, umap, depth, _ = _input_frame(input_data)
    return median_filter_and_densify(undistort_image(depth, umap, nearest=True))


def _k1_inputs(undistorted: torch.Tensor) -> list:
    """K1's inputs, (what, max depth, depth): random and rendered VGA
    maps, a small random one, and `undistorted`, K1's ragged input (rows of
    670 floats are not 16-byte aligned, so the staging takes its scalar
    edge loads)."""
    size = "x".join(map(str, undistorted.shape))
    return [(f"random {HEIGHT}x{WIDTH}", 2.5, _random_depth(0, (HEIGHT, WIDTH), 2.5)),
            ("random 67x160", 2.5, _random_depth(1, (67, 160), 2.5)),
            (f"rendered {HEIGHT}x{WIDTH}", 3.0, _rendered_depth()),
            (f"undistorted input {size}", 3.0, undistorted)]


def _k1(undistorted: torch.Tensor) -> dict:
    """K1 (its default tile) on _k1_inputs against its plain version."""
    result = {}
    for what, max_depth, depth in _k1_inputs(undistorted):
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


def _k2(umap, depth, rgb) -> dict:
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
    _k2_undistortion(umap, depth, rgb)
    return result


def _k2_undistortion(umap, depth, rgb) -> None:
    """K2 at the undistortion's shapes (undistort_image): the nearest depth
    read, [1, H, W] x [1, N], and the four bilinear taps of the color,
    [3, H, W] x [3, N] (N the undistorted pixels), exact."""
    h, w = depth.shape
    px, py = umap[..., 0], umap[..., 1]
    xi = torch.clamp(torch.floor(px).to(torch.int64), 0, w - 1).reshape(1, -1)
    yi = torch.clamp(torch.floor(py).to(torch.int64), 0, h - 1).reshape(1, -1)
    planes = rgb.permute(2, 0, 1).to(torch.float32).contiguous()
    ix0, iy0, ix1, iy1, _, _ = interp.quad_texels(h, w, px, py)
    taps = {"nearest depth": (depth[None], xi, yi)}
    for tap, (x, y) in {"tl": (ix0, iy0), "tr": (ix1, iy0), "bl": (ix0, iy1),
                        "br": (ix1, iy1)}.items():
        taps[f"color {tap}"] = (planes, x.reshape(1, -1).expand(3, -1).contiguous(),
                                y.reshape(1, -1).expand(3, -1).contiguous())
    for what, (img, x, y) in taps.items():
        err = _exact(kernels.gather_cuda(img, x, y), gather_nearest_plain(img, x, y),
                     f"K2 undistortion {what}")
        ms = device_ms(lambda: kernels.gather_cuda(img, x, y))
        n = x.numel()
        b = _bound(4.0 * img.numel() + 2.0 * 8.0 * n + 4.0 * n, 3.0 * n)
        print(f"K2 gather undistortion {what}: {list(img.shape)} x {list(x.shape)}, "
              f"int64: exact (max_abs_err {err}); device ms {ms:.4f}; bound "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']})")


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


# H2 at the benchmark's scale: a block of 8 keyframe slots of 640x480
# planes against a surfel bucket of 1,048,576 rows, 10% live (the cells'
# ba_live_row_pct reads 10-12%).
H2_KEYFRAMES, H2_ROWS = 8, 1 << 20
# Surfel bytes a live row reads (position, normal, squared radius,
# descriptor), beside its valid byte.
H2_ROW_BYTES = 36.0
# Float operations per associated (surfel, keyframe) pair with both terms,
# counted from csrc/pose_coeffs.cu: association ~60, the depth row and its
# sums ~100, tangents, three bilinear samples and the two descriptor rows
# with their sums ~340.
H2_OPS_PER_PAIR = 500.0


def _h2() -> dict:
    state = synthetic.pose_pass_state(11, H2_KEYFRAMES, H2_ROWS, 0.1, WIDTH, HEIGHT)
    smap, q, t, depth, nx, ny, inten = synthetic.pose_pass_inputs(state, "cuda")
    args = (smap, state.cam, q, t, depth, nx, ny, inten, 40.0, True, True)
    ftg = se3.inverse(se3.SE3(q, t))
    rot = se3.quat_to_matrix(ftg.q).contiguous()
    launch = (smap.pos, smap.normal, smap.radius2, smap.desc, smap.valid, rot, ftg.t,
              depth, nx, ny, inten, state.cam, 40.0, True, True)
    out = kernels.pose_coeffs_cuda(*launch)
    ref = pose_opt.surfel_pose_coeffs_plain(*args)
    if not torch.equal(out[2], ref[2]):
        raise AssertionError(f"H2 counts {out[2].tolist()} against {ref[2].tolist()}")
    rel = max(float(((x - y).abs().flatten(1).amax(1) / y.abs().flatten(1).amax(1)).max())
              for x, y in zip(out[:2], ref[:2]))
    err = max(float((x - y).abs().max()) for x, y in zip(out[:2], ref[:2]))
    # The repo's tolerance for H and b summed in another order
    # (tests/test_torch_ba.py), over ~80,000 terms a keyframe here.
    if rel > 1e-4:
        raise AssertionError(f"H2 against the plain version: {rel} of the largest entry")
    if not all(torch.equal(x, y) for x, y in zip(out, kernels.pose_coeffs_cuda(*launch))):
        raise AssertionError("H2: two launches differ")
    t_ = _timings(lambda: kernels.pose_coeffs_cuda(*launch),
                  lambda: pose_opt.surfel_pose_coeffs_plain(*args))
    step_ms = device_ms(lambda: pose_opt.surfel_pose_coeffs(*args))
    live = int(smap.valid.sum())
    nbytes = smap.valid.numel() + H2_ROW_BYTES * live + 4.0 * 4.0 * depth.numel()
    b = _bound(nbytes, H2_OPS_PER_PAIR * float(out[2].sum()))
    print(f"H2 pose_coeffs {H2_KEYFRAMES} x 480x640 against {H2_ROWS} rows ({live} live, "
          f"{out[2].tolist()} associated): counts exact, max abs err {err:.3e} "
          f"({rel:.3e} of the largest entry), two launches bit for bit; device ms "
          f"kernel {t_['ms']:.4f}, whole step {step_ms:.4f}, plain {t_['plain_ms']:.4f}; "
          f"eager kernel {t_['call_ms']:.4f}, plain {t_['plain_call_ms']:.4f}; bound "
          f"{b['bound_ms']:.5f} ms ({b['bound_by']}); {SMI}")
    return {"max_abs_err": err, "max_rel_err": rel, "step_ms": step_ms, **t_, **b}


# H3 at the benchmark's scale: a keyframe bucket of 32 slots (4 blocks) of
# 640x480 planes against a surfel bucket of 1,048,576 rows, 10% live.
H3_KEYFRAMES, H3_ROWS = 32, 1 << 20
# Bytes a live row moves in one block's launch beside the valid byte (and
# the position pass's active byte): the normals pass reads position and
# normal (24) and reads and writes its carry (flag, normal sum, count: 2 x
# 21); the position pass reads position, normal, squared radius and
# descriptor (36) and reads and writes its 8 sums (2 x 32).
H3_NORMALS_ROW_BYTES, H3_POSITION_ROW_BYTES = 66.0, 100.0
# The finishes: a live row's carry read and its normal written (32), or its
# position, normal, descriptor and 8 sums read and position and descriptor
# written (84); a dead row's output copied (the caller's clone: 24 bytes of
# normal, 40 of position and descriptor).
H3_NORMALS_FINISH_BYTES, H3_POSITION_FINISH_BYTES = 32.0, 84.0
# Float operations per (live row, slot): association ~60; the position
# pass's depth term ~20, tangents, three bilinear samples and the two
# descriptor terms ~200 more.
H3_OPS_ASSOCIATION, H3_OPS_POSITION = 60.0, 280.0


def _h3_equal(what: str, got, want) -> None:
    """Bit for bit, or the phase fails naming the rows that differ."""
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            rows = int((g != w).reshape(g.shape[0] if g.ndim else 1, -1).any(dim=1).sum())
            raise AssertionError(f"H3 {what}: {rows} rows differ from the plain chain")


def _h3() -> dict:
    """H3 against its plain chain at the benchmark's scale, bit for bit:
    each kind's launch over one block of 8 slots (activation, normal sums
    and counts; the position sums; two launches alike), then the whole
    geometry stage (DirectBA._geometry: activation and normals, then
    positions and descriptors over the 32 slots) against the same stage on
    the plain chain; device ms in a graph of each launch, each finish, the
    stage and the plain chain, and their byte bounds. Any mismatch fails
    the phase."""
    from badslam_torch.ba import scheme
    from badslam_torch.ba.scheme import DirectBA

    state = synthetic.pose_pass_state(13, H3_KEYFRAMES, H3_ROWS, 0.1, WIDTH, HEIGHT)
    smap, q, t, depth, nx, ny, inten = synthetic.pose_pass_inputs(state, "cuda")
    cam = state.cam
    slot = torch.arange(H3_KEYFRAMES, device="cuda")
    participating = slot % 8 != 7
    strict = participating & (slot % 3 != 1)
    stack = KeyframeStack(depth, nx, ny, None, inten, q, t, participating)
    block = stack.rows(slice(0, 8))
    live = int(smap.valid.sum())
    n = smap.valid.numel()
    plane = 4.0 * HEIGHT * WIDTH

    # One block of each kind, both kinds' flags.
    def normals(chunk):
        return chunk(geo._act_normals_init(smap), block, strict[:8], participating[:8], smap,
                     cam, 40.0, True)

    got = normals(geo._act_normals_chunk)
    ref = normals(geo._act_normals_chunk_plain)
    _h3_equal("normals", got, ref)
    _h3_equal("normals, a second launch", normals(geo._act_normals_chunk), got)
    pairs = float(ref[2].sum())
    t_n = _timings(lambda: normals(geo._act_normals_chunk),
                   lambda: normals(geo._act_normals_chunk_plain))
    b_n = _bound(n + H3_NORMALS_ROW_BYTES * live + 3 * plane * 8,
                 H3_OPS_ASSOCIATION * live * 8)

    def position(chunk, init):
        return chunk(init(smap, True), block, smap, cam, 40.0, True, True)

    got = position(geo._pos_chunk, geo._pos_init)
    ref = position(geo._pos_chunk_plain, geo._pos_init_plain)
    _h3_equal("position sums", got, torch.stack(ref[:4] + ref[5:]))
    _h3_equal("position sums, a second launch", position(geo._pos_chunk, geo._pos_init), got)
    t_p = _timings(lambda: position(geo._pos_chunk, geo._pos_init),
                   lambda: position(geo._pos_chunk_plain, geo._pos_init_plain))
    b_p = _bound(2 * n + H3_POSITION_ROW_BYTES * live + 4 * plane * 8,
                 H3_OPS_POSITION * live * 8)
    carry = normals(geo._act_normals_chunk)
    finish_ms = {"normals": device_ms(lambda: geo._act_normals_finish(smap, carry, True)),
                 "position": device_ms(lambda: geo._pos_finish(smap, got, True))}
    b_f = _bound(2 * n + (H3_NORMALS_FINISH_BYTES + H3_POSITION_FINISH_BYTES) * live
                 + 64.0 * n, 0.0)

    # The whole stage, as BA runs it, and on the plain chain; its stamps
    # and row counters, captured with it, need the card's stamp table.
    ba = DirectBA(cam, BadSlamConfig(max_surfel_count=H3_ROWS), surfel_capacity=256,
                  device="cuda")
    Timing.stamp_table(ba.device)

    def stage():
        return ba._geometry(smap, None, stack, strict, participating, True)

    def plain_stage():
        kernel_fns = scheme.update_activation_and_normals, scheme._position_step
        scheme.update_activation_and_normals = geo.update_activation_and_normals_plain
        scheme._position_step = geo._position_step_plain
        try:
            return stage()
        finally:
            scheme.update_activation_and_normals, scheme._position_step = kernel_fns

    before = {k: kernels.launch_counts[k] for k in (kernels.GEOMETRY_NORMALS,
                                                    kernels.GEOMETRY_POSITION)}
    out, ref = stage(), plain_stage()
    launches = {k: kernels.launch_counts[k] - v for k, v in before.items()}
    _h3_equal("stage", out, ref)
    moved = int((ref.pos != smap.pos).any(dim=1).sum())
    stage_ms = device_ms(stage, runs=10, repeats=3)
    plain_stage_ms = device_ms(plain_stage, runs=2, repeats=3)
    blocks = H3_KEYFRAMES // 8
    b_s = _bound(blocks * (3 * n + (H3_NORMALS_ROW_BYTES + H3_POSITION_ROW_BYTES) * live
                           + 7 * plane * 8)
                 + 2 * n + (H3_NORMALS_FINISH_BYTES + H3_POSITION_FINISH_BYTES) * live
                 + 64.0 * n, 0.0)
    print(f"H3 geometry_normals (activation and normals) 8 x 480x640 against {H3_ROWS} rows "
          f"({live} live, {int(pairs)} associated): bit for bit the plain chain, two launches "
          f"alike; device ms kernel {t_n['ms']:.4f}, plain {t_n['plain_ms']:.4f}; eager kernel "
          f"{t_n['call_ms']:.4f}, plain {t_n['plain_call_ms']:.4f}; bound "
          f"{b_n['bound_ms']:.5f} ms ({b_n['bound_by']}); {SMI}")
    print(f"H3 geometry_position (depth and descriptors) 8 x 480x640 against {H3_ROWS} rows: "
          f"bit for bit the plain chain, two launches alike; device ms kernel "
          f"{t_p['ms']:.4f}, plain {t_p['plain_ms']:.4f}; eager kernel {t_p['call_ms']:.4f}, "
          f"plain {t_p['plain_call_ms']:.4f}; bound {b_p['bound_ms']:.5f} ms "
          f"({b_p['bound_by']}); finishes (with the outputs' copies) normals "
          f"{finish_ms['normals']:.4f}, position {finish_ms['position']:.4f} ms, bound "
          f"together {b_f['bound_ms']:.5f} ms")
    print(f"H3 geometry stage (DirectBA._geometry, {H3_KEYFRAMES} slots of 480x640, "
          f"{H3_ROWS} rows): launches {launches}; activation, normals, positions and "
          f"descriptors bit for bit the plain chain's ({moved} rows moved); device ms stage "
          f"{stage_ms:.4f}, plain stage {plain_stage_ms:.4f}; bound {b_s['bound_ms']:.5f} ms "
          f"({b_s['bound_by']}); {SMI}")
    common = {"max_abs_err": 0.0, "library_ms": None, "stage_ms": stage_ms,
              "plain_stage_ms": plain_stage_ms}
    return {kernels.GEOMETRY_NORMALS: {**t_n, **b_n, **common},
            kernels.GEOMETRY_POSITION: {**t_p, **b_p, **common}}


# H1 (the tracker's Gauss-Newton step) at the finest and the coarsest of
# the five levels at VGA.
H1_LEVELS = (0, 4)
# Float operations per valid pixel with both residual types, counted from
# csrc/track_coeffs.cu: association ~80, the descriptor gates, plane
# projections and three bilinear samples ~150, the depth row and its sums
# ~90, the two descriptor rows and their sums ~170.
H1_OPS_PER_PIXEL = 500.0


def _h1_paths(level, args, truth) -> str:
    """What the SLAM paths call of H1 at one level, against the plain chain
    on the same inputs: the whole step (pairwise._gn_step: q and t within
    1e-6, the same flag), the cost (count exact, cost within 1e-5
    relative) and the duel's pick, for a near and a far pair."""
    cam, base, tracked, q, t, s, bfx, *flags = args
    step = (*args[:6], 0.5, *args[6:])
    q_k, t_k, done_k = pairwise._gn_step(*step)
    q_p, t_p, done_p = pairwise._gn_step_plain(*step)
    step_err = max(float((q_k - q_p).abs().max()), float((t_k - t_p).abs().max()))
    if step_err > 1e-6 or bool(done_k) != bool(done_p):
        raise AssertionError(f"H1 step at level {level}: q, t off by {step_err}, flag "
                             f"{bool(done_k)} against {bool(done_p)}")
    cost, n = pairwise.compute_cost_and_count(*args)
    cost_p, n_p = pairwise.compute_cost_and_count_plain(*args)
    cost_rel = abs(float(cost) - float(cost_p)) / abs(float(cost_p))
    if not torch.equal(n, n_p) or cost_rel > 1e-5:
        raise AssertionError(f"H1 cost at level {level}: count {int(n)} against {int(n_p)}, "
                             f"cost {cost_rel} relative")
    near = (q, t)
    far = (truth[0], truth[1] + torch.tensor([0.2, -0.1, 0.05], device=t.device))
    for a, b in ((truth, near), (near, truth), (truth, far), (far, near)):
        got = pairwise._duel(cam, base, tracked, *a, *b, s, bfx, *flags)
        want = pairwise._duel_plain(cam, base, tracked, *a, *b, s, bfx, *flags)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"H1 duel at level {level} picks another pose than plain")
    return (f"step q, t within {step_err:.3e} of plain, flag {bool(done_k)} as plain; cost "
            f"{cost_rel:.3e} relative, count exact; duel picks as plain (near and far pairs)")


def _h1() -> dict:
    """H1 against its plain chain at 480x640 and 30x40 (levels 0 and 4 of
    the rendered pair): counts exact, H and b against the largest entry,
    two launches bit for bit, and the step, cost and duel that the SLAM
    paths call (_h1_paths); device ms per call in a graph of 50 of the
    coefficient kernel, of the whole step (pairwise._gn_step: both
    kernels) and of the plain chain's accumulation and step beside them."""
    cams, base, tracked, truth = synthetic.tracking_pair(
        synthetic.default_camera(WIDTH, HEIGHT), 7, "cuda")
    q = truth[0] + torch.tensor([0.0, 0.001, -0.0015, 0.0005], device="cuda")
    q = q / torch.linalg.vector_norm(q)
    t = truth[1] + torch.tensor([0.004, 0.003, -0.005], device="cuda")
    out = {}
    for level in H1_LEVELS:
        s = float(2 ** level)
        args = (cams[level], base[level], tracked[level], q, t, s, 40.0, True, True, False)
        step = (*args[:6], 1.0, *args[6:])
        got = pairwise.accumulate_pose_coeffs(*args)
        ref = pairwise.accumulate_pose_coeffs_plain(*args)
        if not torch.equal(got[2], ref[2]):
            raise AssertionError(f"H1 count {int(got[2])} against {int(ref[2])}")
        rel = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(got[:2], ref[:2]))
        err = max(float((x - y).abs().max()) for x, y in zip(got[:2], ref[:2]))
        if rel > 1e-5:
            raise AssertionError(f"H1 against the plain chain: {rel} of the largest entry")
        if not all(torch.equal(x, y) for x, y in zip(got, pairwise.accumulate_pose_coeffs(*args))):
            raise AssertionError("H1: two launches differ")
        paths = _h1_paths(level, args, truth)
        t_ = _timings(lambda: pairwise.accumulate_pose_coeffs(*args),
                      lambda: pairwise.accumulate_pose_coeffs_plain(*args))
        step_ms = device_ms(lambda: pairwise._gn_step(*step))
        plain_step_ms = device_ms(lambda: pairwise._gn_step_plain(*step))
        h, w = base[level].depth.shape
        b = _bound(4.0 * 4.0 * h * w, H1_OPS_PER_PIXEL * float(got[2]))
        print(f"H1 track_coeffs {h}x{w} ({int(got[2])} valid pixels, depth and descriptor "
              f"residuals): count exact, max abs err {err:.3e} ({rel:.3e} of the largest "
              f"entry), two launches bit for bit; {paths}; device ms kernel {t_['ms']:.4f}, whole step "
              f"{step_ms:.4f}, plain accumulation {t_['plain_ms']:.4f}, plain step "
              f"{plain_step_ms:.4f}; eager kernel {t_['call_ms']:.4f}, plain "
              f"{t_['plain_call_ms']:.4f}; bound {b['bound_ms']:.5f} ms ({b['bound_by']}); "
              f"{SMI}")
        out[level] = {"max_abs_err": err, "max_rel_err": rel, "step_ms": step_ms,
                      "plain_step_ms": plain_step_ms, **t_, **b}
    return out[0]


def phase_kernels(input_data: str) -> dict:
    _, umap, depth, rgb = _input_frame(input_data)
    return {kernels.BILATERAL: _k1(_undistorted_frame(input_data)),
            kernels.GATHER: _k2(umap, depth, rgb), kernels.GATHER_ONEHOT: _k3(),
            kernels.POSE_COEFFS: _h2(), kernels.TRACK_COEFFS: _h1(), **_h3()}


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


def _run_slam(data, workdir, tag, device, flags, mesh=None):
    """The CLI (badslam_torch.cli.run, what cli.main runs) on one device
    (BA on `mesh`, when given), on a dataset directory or on the source
    arguments `data` (a list, e.g. ["--live", "dir:<path>"]); returns
    (BadSlam, poses, q, t, summary, launches)."""
    poses_path = os.path.join(workdir, f"{tag}_poses.txt")
    times_path = os.path.join(workdir, f"{tag}_times.json")
    source = data if isinstance(data, list) else [data]
    kernels.reset_launch_counts()
    slam = cli.run([*source, "--device", device, *flags, "--export_poses", poses_path,
                    "--export_frame_times", times_path], mesh=mesh)
    launches = dict(kernels.launch_counts)
    poses, q, t = _poses(poses_path)
    if not (np.all(np.isfinite(q)) and np.all(np.isfinite(t))):
        raise AssertionError(f"{tag}: non-finite poses")
    with open(times_path) as f:
        summary = json.load(f)
    return slam, poses, q, t, summary, launches


def _run(data, workdir, tag, device, flags, mesh=None):
    """cli.main on one device; returns (poses, q, t, summary, launches)."""
    return _run_slam(data, workdir, tag, device, flags, mesh)[1:]


def _write(workdir, name, width, height, frames, seed, planes=6, camera=None,
           distortion=None):
    data = os.path.join(workdir, name)
    gt = synthetic.smooth_trajectory(frames)
    synthetic.write_tum_dataset(
        data, camera or synthetic.default_camera(width, height),
        synthetic.random_plane_scene(np.random.default_rng(seed), planes), gt,
        distortion=distortion)
    return data, gt


def _frame_medians(summary) -> str:
    """Per-frame medians: all frames after the first, keyframe (BA) frames
    (those whose BA call self-calibrated apart), frames that drained queued
    BA iterations, the other frames."""
    frame_ms = dict(summary["frame_ms"])
    kf_set, drain_set = set(summary["keyframe_frames"]), set(summary["ba_drain_frames"])
    calib_set = set(summary["self_calibration_frames"])
    later = [frame_ms[i] for i in sorted(frame_ms)[1:]]
    groups = {"keyframe": [frame_ms[i] for i in summary["keyframe_frames"][1:]
                           if i not in calib_set],
              "self-calibrating keyframe": [frame_ms[i] for i in sorted(calib_set)],
              "BA-drain": [frame_ms[i] for i in drain_set - kf_set],
              "other": [frame_ms[i] for i in sorted(frame_ms)[1:]
                        if i not in kf_set and i not in drain_set]}
    parts = [f"per-frame median {statistics.median(later):.2f} ms after the first "
             f"(first {frame_ms[min(frame_ms)]:.2f})"]
    parts += [f"{k} frames median {statistics.median(v):.2f} ms ({len(v)})"
              for k, v in groups.items() if v]
    return "; ".join(parts)


def _shapes() -> dict:
    """The launches per image shape (and K1's tile) of the last run
    (copied)."""
    return {k: dict(v) for k, v in kernels.launch_shapes.items()}


def _default_tile() -> tuple:
    return kernels.bilateral_tiles()[0]


def phase_slice(workdir: str) -> tuple:
    data, gt = _write(workdir, "sequence", WIDTH, HEIGHT, FRAMES, 7)
    ply = os.path.join(workdir, "map.ply")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    poses, q, t, summary, launches = _run(
        data, workdir, "slice", "cuda", SLICE_FLAGS + ["--export_point_cloud", ply])
    wall = time.perf_counter() - t0
    shapes = _shapes()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ate = synthetic.ate_rmse(poses, gt)
    frame_ms = dict(summary["frame_ms"])
    later = [frame_ms[i] for i in sorted(frame_ms)[1:]]
    kf = [frame_ms[i] for i in summary["keyframe_frames"][1:]]
    points = _ply_points(ply)
    print(f"slice: {FRAMES} frames at {WIDTH}x{HEIGHT} on cuda in {wall:.1f} s wall; "
          f"ATE {ate:.3e} m (limit {ATE_LIMIT_M}); {_frame_medians(summary)}; min "
          f"{min(later):.2f}, max {max(later):.2f} ms after the first; keyframe (BA) "
          f"frames {', '.join(f'{x:.1f}' for x in kf)} ms; BA iterations per call "
          f"{summary['ba_iterations']}; keyframes {summary['keyframes']}; surfels "
          f"{summary['surfels']}; PLY points {points}; peak memory {peak_mb:.1f} MiB; "
          f"launches {launches}")
    checks = {
        "K1 once per frame": launches[kernels.BILATERAL] == FRAMES,
        "K1 with its default tile":
            shapes[kernels.BILATERAL] == {(HEIGHT, WIDTH, _default_tile()): FRAMES},
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
    return data, launches, q, t, summary


STEADY_ATOL = 1e-6


def _steady_run(data: str, graph: bool) -> dict:
    """The slice's frames and flags through BadSlam.run on cuda: with the
    steady frame's CUDA graphs, or (graph false) with the same steady-frame
    function called eagerly with the host-read Gauss-Newton loop."""
    config = cli.config_from_args(cli.build_parser().parse_args([data, *SLICE_FLAGS]))
    slam = BadSlam(config, load_tum_dataset(data), "cuda")
    if not graph:
        slam.steady_graph = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    slam.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    frame_ms = dict(slam.frame_times_ms)
    kf, drain = set(slam.keyframe_frames), set(slam.ba_drain_frames)
    steady = [frame_ms[i] for i in sorted(frame_ms)[1:] if i not in kf and i not in drain]
    out = dict(
        slam=slam, wall=wall, launches=launches, q=slam.traj_q.cpu().numpy(),
        t=slam.traj_t.cpu().numpy(), steady_ms=statistics.median(steady),
        keyframe_ms=statistics.median([frame_ms[i] for i in slam.keyframe_frames[1:]]),
        drain_ms=statistics.median([frame_ms[i] for i in drain - kf]),
        gn_per_frame=slam.steady_gn_iterations() / (len(frame_ms) - 1),
        peak_mib=torch.cuda.max_memory_allocated() / 2**20,
        chunks=slam.chunks_processed)
    return out


def _steady_window(data: str, graph: bool) -> dict:
    """Steady frames alone, with the graphs (`graph`) or the eager call: the
    slice's frames with BA off, run to frame 10 (the graphs captured), then
    frames 11-19 as one chunk, timed: the host's wall time from the first
    enqueue to the card's end and the card's span between CUDA events
    around it; with graphs, the kernel nodes the card ran (node counts x
    body runs). Then keyframe 20, and frames 21-23 as a chunk under
    torch.profiler: the kernels and their device time as the profiler sees
    them, host launches and graph replays. All per frame."""
    from torch.profiler import ProfilerActivity, profile

    args = cli.build_parser().parse_args(
        [data, *SLICE_FLAGS, "--max_num_ba_iterations_per_keyframe", "0"])
    slam = BadSlam(cli.config_from_args(args), load_tum_dataset(data), "cuda")
    if not graph:
        slam.steady_graph = None
    slam.run(0, 11)
    nodes0 = slam.steady_graph.kernel_nodes_run() if graph else 0
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start_ev.record()
    slam._process_chunk(11, 9, [])
    end_ev.record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / 9
    nodes_run = (slam.steady_graph.kernel_nodes_run() - nodes0) / 9 if graph else None
    slam.process_frame(20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        slam._process_chunk(21, 3, [])
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels_ = [e for e in events if e.device_type.name == "CUDA" and not e.is_user_annotation]
    host = sum(e.count for e in events if e.device_type.name == "CPU" and e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))
    return dict(
        wall_ms=wall_ms, span_ms=start_ev.elapsed_time(end_ev) / 9, nodes_run=nodes_run,
        profiled_kernels=sum(e.count for e in kernels_) / 3,
        profiled_kernel_ms=sum(e.self_device_time_total for e in kernels_) / 1e3 / 3,
        host_launches=host / 3,
        replays=sum(e.count for e in events if e.key == "cudaGraphLaunch") / 3)


def phase_steady(data: str) -> None:
    """The steady frame as one CUDA graph per frame against the eager call
    of the same function with the host-read loop, on the slice's frames;
    then the steady frames alone on each path (_steady_window)."""
    runs = {"graph": _steady_run(data, True), "eager": _steady_run(data, False)}
    g, e = runs["graph"], runs["eager"]
    replays = g["slam"].steady_graph.replays
    windows = {k: _steady_window(data, k == "graph") for k in ("graph", "eager")}
    dq, dt = float(np.abs(g["q"] - e["q"]).max()), float(np.abs(g["t"] - e["t"]).max())
    caps = g["slam"].steady_graph.captures
    print(f"steady ({SMI}): {FRAMES} VGA frames, graph / eager host loop: steady-frame "
          f"median {g['steady_ms']:.3f} / {e['steady_ms']:.3f} ms, keyframe frames "
          f"{g['keyframe_ms']:.3f} / {e['keyframe_ms']:.3f} ms, BA-drain frames "
          f"{g['drain_ms']:.3f} / {e['drain_ms']:.3f} ms; wall {g['wall']:.2f} / "
          f"{e['wall']:.2f} s; chunks {g['chunks']} / {e['chunks']}; max |dq| {dq:.3e}, "
          f"|dt| {dt:.3e} (atol {STEADY_ATOL}); GN iterations per frame "
          f"{g['gn_per_frame']:.2f} / {e['gn_per_frame']:.2f}; launches {g['launches']} / "
          f"{e['launches']}; peak memory {g['peak_mib']:.1f} / {e['peak_mib']:.1f} MiB")
    gw, ew = windows["graph"], windows["eager"]
    print(f"  steady frames 11-19 with BA off, per frame, graph / eager: wall "
          f"{gw['wall_ms']:.3f} / {ew['wall_ms']:.3f} ms, the card's span "
          f"{gw['span_ms']:.3f} / {ew['span_ms']:.3f} ms; graph: {gw['nodes_run']:.1f} kernel "
          f"nodes run (node counts x body runs), the card on the graphs "
          f"{100 * gw['span_ms'] / gw['wall_ms']:.1f}% of the wall time; eager: kernel time "
          f"{ew['profiled_kernel_ms']:.3f} ms, the card busy "
          f"{100 * ew['profiled_kernel_ms'] / ew['wall_ms']:.1f}% of the wall time; frames "
          f"21-23 under torch.profiler, graph / eager: {gw['profiled_kernels']:.1f} / "
          f"{ew['profiled_kernels']:.1f} kernels seen, {gw['profiled_kernel_ms']:.3f} / "
          f"{ew['profiled_kernel_ms']:.3f} ms kernel time, {gw['host_launches']:.1f} / "
          f"{ew['host_launches']:.1f} host launches, {gw['replays']:.1f} / "
          f"{ew['replays']:.1f} graph replays")
    for c in caps:
        print(f"  graph (test_two {c['test_two']}): capture {c['capture_s']:.3f} s, "
              f"instantiate {c['instantiate_s']:.3f} s, {c['nodes']} nodes "
              f"({c['kernel_nodes']} kernel nodes: {c['top_kernel_nodes']} outside the "
              f"bodies of its {c['while_nodes']} WHILE nodes, per body in capture order "
              f"{c['body_kernel_nodes']}), {c['replays']} replays, pools "
              f"{c['reserved_mib']:.1f} MiB")
    checks = {
        "graph poses equal the eager call's": dq <= STEADY_ATOL and dt <= STEADY_ATOL,
        "K1 once per frame in both": (g["launches"][kernels.BILATERAL]
                                      == e["launches"][kernels.BILATERAL] == FRAMES),
        "K2 launches equal": g["launches"][kernels.GATHER] == e["launches"][kernels.GATHER] > 0,
        "H1 launches equal": (g["launches"][kernels.TRACK_COEFFS]
                              == e["launches"][kernels.TRACK_COEFFS] > 0),
        "every steady frame replayed": replays == FRAMES - 1,
        "chunks ran": g["chunks"] == e["chunks"] > 0,
        "GN iterations equal": g["gn_per_frame"] == e["gn_per_frame"] > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"steady checks failed: {failed}")


BA_GRAPH_ATOL = 1e-6


def _ba_run(data: str, graph: bool) -> dict:
    """The slice's frames and flags through BadSlam.run on cuda: with the
    fused BA calls as CUDA-graph replays, or (graph false) with the same
    function called eagerly with the host loops. The steady frames are
    graph replays in both."""
    config = cli.config_from_args(cli.build_parser().parse_args([data, *SLICE_FLAGS]))
    slam = BadSlam(config, load_tum_dataset(data), "cuda")
    if not graph:
        slam.ba_graph = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    slam.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    frame_ms = dict(slam.frame_times_ms)
    kf, drain = set(slam.keyframe_frames), set(slam.ba_drain_frames)
    steady = [frame_ms[i] for i in sorted(frame_ms)[1:] if i not in kf and i not in drain]
    ba = slam.direct_ba
    return dict(
        slam=slam, wall=wall, launches=launches, q=slam.traj_q.cpu().numpy(),
        t=slam.traj_t.cpu().numpy(), steady_ms=statistics.median(steady),
        keyframe_ms=statistics.median([frame_ms[i] for i in slam.keyframe_frames[1:]]),
        drain_ms=statistics.median([frame_ms[i] for i in drain - kf]),
        iterations=list(ba.iterations_run), surfels=ba.surfel_count,
        ba_ms=ba.ba_spans.ms(), peak_mib=torch.cuda.max_memory_allocated() / 2**20)


def _ba_sync_check(data: str) -> dict:
    """One replayed drain and one replayed keyframe call, each with the
    trajectory deformation after it, under torch.cuda.set_sync_debug_mode
    ("error"), with sync_surfel_bucket false: frames 0-20 of the slice run
    first (their BA calls capture the graphs of both kinds). Raises if
    either syncs."""
    args = cli.build_parser().parse_args(
        [data, *SLICE_FLAGS, "--sync_surfel_bucket", "false"])
    slam = BadSlam(cli.config_from_args(args), load_tum_dataset(data), "cuda")
    slam.run(0, 21)
    graph, ba = slam.ba_graph, slam.direct_ba
    captures, replays = len(graph.captures), graph.replays
    queued = slam.queued_ba_iterations
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slam._drain_queued_ba(2, 20)
        old = slam._remember_keyframe_poses()
        ba.bundle_adjustment(max_iterations=2, loop=slam.ba_loop, graph=graph)
        slam._apply_ba_pose_updates(*old)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return dict(captures=len(graph.captures) - captures, replays=graph.replays - replays,
                drained=queued - slam.queued_ba_iterations,
                iterations=ba.iterations_run[-2:])


def _drain_calls_ms(slam, calls: int = 4) -> list:
    """Device ms (CUDA events) of `calls` drain calls of 2 iterations on the
    finished run's state: replays of one graph (the first call captures it)
    or eager calls; the first call is dropped."""
    ms = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        slam.direct_ba.bundle_adjustment(max_iterations=2, increase_ba_iteration_count=False,
                                         loop=slam.ba_loop, graph=slam.ba_graph)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return ms[1:]


def phase_ba_graph(data: str) -> None:
    """The fused BA call as one CUDA graph per call against the eager call
    of the same function with the host loops, on the slice's frames, and
    then three more drain calls on each finished state, timed; then a
    replayed drain and keyframe call under the sync check."""
    runs = {"graph": _ba_run(data, True), "eager": _ba_run(data, False)}
    g, e = runs["graph"], runs["eager"]
    bag = g["slam"].ba_graph
    dq, dt = float(np.abs(g["q"] - e["q"]).max()), float(np.abs(g["t"] - e["t"]).max())
    drain_ms = {k: _drain_calls_ms(r["slam"]) for k, r in runs.items()}
    sync = _ba_sync_check(data)
    print(f"ba_graph ({SMI}): {FRAMES} VGA frames, BA graph / eager host loops: keyframe "
          f"frames median {g['keyframe_ms']:.3f} / {e['keyframe_ms']:.3f} ms, BA-drain frames "
          f"{g['drain_ms']:.3f} / {e['drain_ms']:.3f} ms, steady frames {g['steady_ms']:.3f} / "
          f"{e['steady_ms']:.3f} ms; BA ms per call {_ms_median(g['ba_ms'])} / "
          f"{_ms_median(e['ba_ms'])}; wall {g['wall']:.2f} / {e['wall']:.2f} s; BA iterations "
          f"per call {g['iterations']} / {e['iterations']}; max |dq| {dq:.3e}, |dt| {dt:.3e} "
          f"(atol {BA_GRAPH_ATOL}); surfels {g['surfels']} / {e['surfels']}; launches "
          f"{g['launches']} / {e['launches']}; replays {bag.replays}; peak memory "
          f"{g['peak_mib']:.1f} / {e['peak_mib']:.1f} MiB; then drain calls of 2 "
          f"iterations on the finished state, device ms per call: replays "
          f"{', '.join(f'{x:.3f}' for x in drain_ms['graph'])} / eager "
          f"{', '.join(f'{x:.3f}' for x in drain_ms['eager'])}")
    for c in bag.captures:
        print(f"  BA graph (scheme-end first {c['end_first']}, last {c['end_last']}, "
              f"keyframe bucket {c['keyframe_bucket']}, surfel bucket {c['surfel_bucket']}): "
              f"capture {c['capture_s']:.3f} s, instantiate {c['instantiate_s']:.3f} s, "
              f"{c['nodes']} nodes ({c['kernel_nodes']} kernel nodes: "
              f"{c['top_kernel_nodes']} outside the bodies of its {c['while_nodes']} WHILE "
              f"nodes, per body {c['body_kernel_nodes']}), {c['replays']} replays, pools "
              f"{c['reserved_mib']:.1f} MiB")
    print(f"  under set_sync_debug_mode('error') with sync_surfel_bucket false: a replayed "
          f"drain ({sync['drained']} iterations queued) and keyframe call, iterations "
          f"{sync['iterations']}, {sync['replays']} replays, {sync['captures']} captures, "
          f"no sync")
    checks = {
        "graph poses equal the eager call's": dq <= BA_GRAPH_ATOL and dt <= BA_GRAPH_ATOL,
        "BA iterations equal": g["iterations"] == e["iterations"] and sum(g["iterations"]) > 0,
        "K2 launches equal": g["launches"][kernels.GATHER] == e["launches"][kernels.GATHER] > 0,
        "K1 once per frame in both": (g["launches"][kernels.BILATERAL]
                                      == e["launches"][kernels.BILATERAL] == FRAMES),
        "surfel counts equal": g["surfels"] == e["surfels"] > 0,
        "every BA call replayed": bag.replays == len(g["iterations"]) + len(drain_ms["graph"]) + 1,
        "the sync check replayed both calls": sync["replays"] == 2 and sync["captures"] == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"ba_graph checks failed: {failed}")


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


def phase_cpu(workdir: str, data: str, q_odo, t_odo) -> tuple:
    """Returns the 160x120 sequence and its CUDA run's poses (q, t)."""
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
    return small, qg, tg


def write_input_sequence(workdir: str):
    """The distorted raw TUM sequence of phase_input; returns (path, ground
    truth of the frames the loader associates)."""
    data, gt = _write(workdir, "radtan_raw", WIDTH, HEIGHT, INPUT_FRAMES, 7,
                      camera=INPUT_CAMERA, distortion=INPUT_DISTORTION)
    synthetic.make_raw_tum_lists(data, depth_offset_s=0.007, drop_depth=(INPUT_DROP,))
    return data, [p for i, p in enumerate(gt) if i != INPUT_DROP]


def phase_input(workdir: str, data: str, gt_kept) -> None:
    """Distorted raw TUM input (write_input_sequence) through the CLI:
    undistortion, median, BA and the final BA."""
    video, umap, depth, rgb = _input_frame(data)
    size = (video.camera.height, video.camera.width)
    t0 = time.perf_counter()
    poses, q, t, summary, launches = _run(data, workdir, "input", "cuda", INPUT_FLAGS)
    shapes = _shapes()
    wall = time.perf_counter() - t0
    ate = synthetic.ate_rmse(poses, gt_kept)

    # The device time of one frame's undistortion (depth nearest, color
    # bilinear) and median pass, as preprocess_frame runs them.
    def undistort_and_median():
        d = undistort_image(depth, umap, nearest=True)
        undistort_image(rgb.to(torch.float32), umap)
        return median_filter_and_densify(d)

    input_ms = device_ms(undistort_and_median)
    print(f"input: {len(gt_kept)} of {INPUT_FRAMES} raw TUM frames associated, "
          f"{WIDTH}x{HEIGHT} radtan source undistorted to {size[1]}x{size[0]}, on cuda "
          f"in {wall:.1f} s wall; ATE {ate:.3e} m (limit {INPUT_ATE_LIMIT_M}); "
          f"{_frame_medians(summary)}; undistortion + median device time per frame "
          f"{input_ms:.4f} ms (CUDA graph of 50, median of 5); BA iterations per call "
          f"{summary['ba_iterations']}; final BA {summary['final_ba_s']:.2f} s, iterations "
          f"per call {summary['final_ba_iterations']}; keyframes {summary['keyframes']}; "
          f"surfels {summary['surfels']}; launches {launches}; K1 shapes "
          f"{shapes[kernels.BILATERAL]} ({SMI})")
    checks = {
        f"{len(gt_kept)} frames associated": len(video) == len(gt_kept) == len(poses),
        f"decided pinhole {INPUT_SIZE[1]}x{INPUT_SIZE[0]}": size == INPUT_SIZE,
        "K1 once per frame at the decided size, default tile":
            shapes[kernels.BILATERAL] == {(*size, _default_tile()): len(gt_kept)},
        "K2 launched": launches[kernels.GATHER] > 0,
        "final BA ran iterations": sum(summary["final_ba_iterations"]) > 0,
        "ATE below the limit": ate < INPUT_ATE_LIMIT_M,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"input checks failed: {failed}")


def phase_pyramid(workdir: str) -> None:
    """A 1280x960 source processed at input pyramid level 1 (640x480)."""
    data, gt = _write(workdir, "pyramid", 2 * WIDTH, 2 * HEIGHT, PYRAMID_FRAMES, 7)
    t0 = time.perf_counter()
    poses, q, t, summary, launches = _run(data, workdir, "pyramid", "cuda", PYRAMID_FLAGS)
    shapes = _shapes()
    wall = time.perf_counter() - t0
    ate = synthetic.ate_rmse(poses, gt)
    print(f"pyramid: {PYRAMID_FRAMES} frames of a {2 * WIDTH}x{2 * HEIGHT} source at "
          f"input level 1 on cuda in {wall:.1f} s wall; ATE {ate:.3e} m (limit "
          f"{ATE_LIMIT_M}); {_frame_medians(summary)}; BA iterations per call "
          f"{summary['ba_iterations']}; launches {launches}; K1 shapes "
          f"{shapes[kernels.BILATERAL]} ({SMI})")
    checks = {
        "K1 once per frame at 640x480, default tile":
            shapes[kernels.BILATERAL] == {(HEIGHT, WIDTH, _default_tile()): PYRAMID_FRAMES},
        "BA ran iterations": sum(summary["ba_iterations"]) > 0,
        "ATE below the limit": ate < ATE_LIMIT_M,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"pyramid checks failed: {failed}")


def phase_resume(workdir: str, data: str, q_slice, t_slice) -> None:
    """The slice's sequence to frame RESUME_AFTER with --save_state (a
    dataset listing its first frames), then --load_state on the whole
    sequence, against the continuous slice run."""
    first = os.path.join(workdir, "first_half")
    os.makedirs(first)
    with open(os.path.join(data, "associated.txt")) as f:
        rows = [line.split() for line in f if line.strip()][:RESUME_AFTER + 1]
    name = os.path.basename(data)
    with open(os.path.join(first, "associated.txt"), "w") as f:
        f.writelines(f"{a} ../{name}/{b} {c} ../{name}/{d}\n" for a, b, c, d in rows)
    with open(os.path.join(data, "calibration.txt")) as src, \
            open(os.path.join(first, "calibration.txt"), "w") as dst:
        dst.write(src.read())
    snap = os.path.join(workdir, "state.npz")
    _, _, _, saved, _ = _run(first, workdir, "resume_first", "cuda",
                             SLICE_FLAGS + ["--save_state", snap])
    poses, q, t, resumed, launches = _run(data, workdir, "resume_rest", "cuda",
                                          SLICE_FLAGS + ["--load_state", snap])
    dq, dt = float(np.abs(q - q_slice).max()), float(np.abs(t - t_slice).max())
    print(f"resume: snapshot after frame {RESUME_AFTER} of {FRAMES}, "
          f"{os.path.getsize(snap)} bytes, saved in {saved['save_state_s']:.3f} s, "
          f"loaded in {resumed['load_state_s']:.3f} s; resumed frames "
          f"{len(resumed['frame_ms'])}, launches {launches}; against the continuous "
          f"slice run max |dq| {dq:.3e}, max |dt| {dt:.3e} (atol {POSE_ATOL}) ({SMI})")
    if not (len(poses) == FRAMES and len(resumed["frame_ms"]) == FRAMES - RESUME_AFTER - 1
            and dq <= POSE_ATOL and dt <= POSE_ATOL):
        raise AssertionError("the resumed run disagrees with the continuous run")


def phase_cpu_input(workdir: str) -> None:
    """The distorted path with the median filter and the final BA on the
    card and on the CPU."""
    small, _ = _write(workdir, "small_radtan", 96, 72, SMALL_INPUT_FRAMES, 3, planes=5,
                      distortion=(-0.06, 0.01))
    runs = {dev: _run(small, workdir, f"small_radtan_{dev}", dev, SMALL_INPUT_FLAGS)
            for dev in ("cuda", "cpu")}
    (_, qg, tg, sg, lg), (_, qc, tc, sc, _) = runs["cuda"], runs["cpu"]
    dq, dt = float(np.abs(qg - qc).max()), float(np.abs(tg - tc).max())
    ds = abs(sg["surfels"] - sc["surfels"]) / max(sc["surfels"], 1)
    print(f"cpu vs cuda, 96x72 radtan + median + final BA ({SMALL_INPUT_FRAMES} frames): "
          f"max |dq| {dq:.3e}, max |dt| {dt:.3e} (atol {POSE_ATOL}); surfels cuda "
          f"{sg['surfels']} cpu {sc['surfels']} (rel diff {ds:.4f}, limit {SURFEL_RTOL}); "
          f"final BA iterations cuda {sg['final_ba_iterations']} cpu "
          f"{sc['final_ba_iterations']}; cuda launches {lg} ({SMI})")
    if not (len(qg) == len(qc) == SMALL_INPUT_FRAMES and dq <= POSE_ATOL
            and dt <= POSE_ATOL and ds <= SURFEL_RTOL):
        raise AssertionError("CPU and CUDA disagree on the distorted sequence")


def write_miscalibrated_sequence(workdir: str, name: str, width: int, height: int,
                                 frames: int, seed: int):
    """A plane-scene sequence rendered with the true camera whose
    calibration.txt then holds the perturbed one (CALIB_PERTURBATION);
    returns (path, ground truth, true camera)."""
    cam = synthetic.default_camera(width, height)
    data, gt = _write(workdir, name, width, height, frames, seed, camera=cam)
    fx, dcx, dcy = CALIB_PERTURBATION
    with open(os.path.join(data, "calibration.txt"), "w") as f:
        f.write(f"{cam.fx * fx} {cam.fy} {cam.cx + dcx} {cam.cy + dcy}\n")
    return data, gt, cam


def _intrinsics_error(values, cam) -> str:
    fx, fy, cx, cy = values
    return (f"fx {(fx - cam.fx) / cam.fx:+.3e} rel, fy {(fy - cam.fy) / cam.fy:+.3e} rel, "
            f"cx {cx - cam.cx:+.3f} px, cy {cy - cam.cy:+.3f} px")


def _calibrated(workdir: str, tag: str, data: str, flags, device="cuda"):
    """A self-calibrating run through the CLI with --export_calibration;
    returns (BadSlam, poses, q, t, summary, launches, (fx, fy, cx, cy), a,
    cfactor) and checks that the calibration is finite."""
    prefix = os.path.join(workdir, f"{tag}_calibration")
    out = _run_slam(data, workdir, tag, device, flags + ["--export_calibration", prefix])
    (fx, fy, cx, cy, _, _), a, cfactor = load_calibration(prefix)
    if not (np.all(np.isfinite([fx, fy, cx, cy, a])) and np.all(np.isfinite(cfactor))):
        raise AssertionError(f"{tag}: non-finite calibration")
    return out + ((fx, fy, cx, cy), a, cfactor)


def _ms_summary(values) -> str:
    if not values:
        return "none"
    return (f"median {statistics.median(values):.2f} ms, min {min(values):.2f}, "
            f"max {max(values):.2f} ({len(values)})")


def phase_calibration(workdir: str) -> tuple:
    """Path (a): the default parallel alternating BA self-calibrating at VGA."""
    data, gt, cam = write_miscalibrated_sequence(workdir, "calibration", WIDTH, HEIGHT,
                                                 CALIB_FRAMES, 7)
    perturbed = (cam.fx * CALIB_PERTURBATION[0], cam.fy, cam.cx + CALIB_PERTURBATION[1],
                 cam.cy + CALIB_PERTURBATION[2])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, poses, q, t, summary, launches, after, a, cfactor = _calibrated(
        workdir, "calibration", data, CALIB_FLAGS)
    wall = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ate = synthetic.ate_rmse(poses, gt)
    steps = summary["intrinsics_step_ms"]
    print(f"self-calibration (path a): {CALIB_FRAMES} frames at {WIDTH}x{HEIGHT} on cuda, "
          f"parallel BA, in {wall:.1f} s wall; ATE {ate:.3e} m (limit {CALIB_ATE_LIMIT_M}); "
          f"intrinsics error before {_intrinsics_error(perturbed, cam)}, after "
          f"{_intrinsics_error(after, cam)}; a {a:+.3e}, cfactor in "
          f"[{cfactor.min():+.3e}, {cfactor.max():+.3e}]; {_frame_medians(summary)}; "
          f"intrinsics steps {len(steps)}, {_ms_summary(steps)} per step; self-calibrating "
          f"keyframe frames {summary['self_calibration_frames']}; BA iterations per call "
          f"{summary['ba_iterations']}; keyframes {summary['keyframes']}; surfels "
          f"{summary['surfels']}; peak memory {peak_mb:.1f} MiB; launches {launches} "
          f"({SMI})")
    checks = {
        "the intrinsics step ran": len(steps) > 0,
        "the camera changed": tuple(after) != perturbed,
        f"{CALIB_FRAMES} poses": len(poses) == CALIB_FRAMES,
        "K2 launched": launches[kernels.GATHER] > 0,
        "ATE below the limit": ate < CALIB_ATE_LIMIT_M,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"self-calibration checks failed: {failed}")
    return data, gt, cam


def _apply_timing(ba) -> str:
    """One matrix-free product A p of the PCG system at the run's end (all
    keyframes, the map's live prefix, intrinsics unknowns on): its time
    between CUDA events (median of 10 eager calls: the product copies small
    host constants to the card, which a CUDA graph cannot capture), its K2
    launches and its device kernel launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    ks = ba.keyframes
    smap = ba._working_map(0)
    smap = smap._replace(active=smap.valid)
    c = ba.config
    system = PCGSystem(smap, ba.cam, ks.stack(), ks.stack_raw(), ba.depth_params,
                       baseline_fx=c.baseline_fx, use_depth=c.use_geometric_residuals,
                       use_descriptor=c.use_photometric_residuals, gauge_kf=0,
                       cell_size=c.sparse_surfel_cell_size, optimize_intrinsics=True)
    p, _ = system.rhs_and_diagonal()
    kernels.reset_launch_counts()
    system.apply(p)
    torch.cuda.synchronize()
    k2 = kernels.launch_counts[kernels.GATHER]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        system.apply(p)
        torch.cuda.synchronize()
    launched = sum(e.count for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and not e.is_user_annotation)
    ms = call_ms(lambda: system.apply(p), runs=10)
    return (f"A p at K={ks.count} keyframes, N={smap.capacity} surfels: {ms:.3f} ms "
            f"between CUDA events (median of 10 eager calls), {k2} K2 launches and "
            f"{launched} device kernel launches per product")


def phase_pcg(workdir: str, data: str, gt, cam) -> None:
    """Paths (b) and (c): sequential PCG BA self-calibrating at each keyframe
    the gate lets through, then the final BA's PCG pass."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    slam, poses, q, t, summary, launches, after, a, cfactor = _calibrated(
        workdir, "pcg", data, PCG_FLAGS)
    wall = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ate = synthetic.ate_rmse(poses, gt)
    cg, outer_ms = summary["cg_steps"], summary["pcg_iteration_ms"]
    final_n = summary["final_ba_iterations"][0] if summary["final_ba_iterations"] else 0
    ba = slam.direct_ba
    calibrated = (ba.cam.fx, ba.cam.fy, ba.cam.cx, ba.cam.cy)
    print(f"PCG (paths b + c): {CALIB_FRAMES} frames at {WIDTH}x{HEIGHT} on cuda, "
          f"sequential PCG BA with self-calibration and the final PCG pass, in {wall:.1f} s "
          f"wall; ATE {ate:.3e} m (limit {PCG_ATE_LIMIT_M}); intrinsics error after the "
          f"frames (exported) {_intrinsics_error(after, cam)}, after the final pass "
          f"{_intrinsics_error(calibrated, cam)}; {_frame_medians(summary)}; PCG outer "
          f"iterations {len(cg)} ({final_n} in the final pass), CG steps per outer "
          f"iteration {cg}; ms per outer iteration {_ms_summary(outer_ms[:len(outer_ms) - final_n])} "
          f"at keyframes, {_ms_summary(outer_ms[len(outer_ms) - final_n:])} in the final "
          f"pass; final PCG pass {summary['final_ba_s']:.2f} s; keyframes "
          f"{summary['keyframes']}; surfels {summary['surfels']}; peak memory "
          f"{peak_mb:.1f} MiB; launches {launches} ({SMI})")
    print(f"PCG: {_apply_timing(ba)} ({SMI})")
    checks = {
        "PCG outer iterations ran": len(cg) > final_n > 0,
        "CG steps taken": all(s > 0 for s in cg),
        "the camera changed": calibrated != (cam.fx * CALIB_PERTURBATION[0], cam.fy,
                                             cam.cx + CALIB_PERTURBATION[1],
                                             cam.cy + CALIB_PERTURBATION[2]),
        f"{CALIB_FRAMES} poses": len(poses) == CALIB_FRAMES,
        "K2 launched": launches[kernels.GATHER] > 0,
        "ATE below the limit": ate < PCG_ATE_LIMIT_M,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"PCG checks failed: {failed}")


def phase_cpu_calibration(workdir: str) -> None:
    """Paths (a) and (b) with self-calibration on the card and on the CPU."""
    small, _, _ = write_miscalibrated_sequence(workdir, "small_calibration", 96, 72,
                                               SMALL_CALIB_FRAMES, 5)
    failed = []
    for path, flags in (("alternating", SMALL_CALIB_FLAGS), ("pcg", SMALL_PCG_FLAGS)):
        runs = {dev: _calibrated(workdir, f"small_{path}_{dev}", small, flags, dev)
                for dev in ("cuda", "cpu")}
        g, c = runs["cuda"], runs["cpu"]
        dq, dt = float(np.abs(g[2] - c[2]).max()), float(np.abs(g[3] - c[3]).max())
        ds = abs(g[4]["surfels"] - c[4]["surfels"]) / max(c[4]["surfels"], 1)
        dcam = float(np.max(np.abs(np.subtract(g[6], c[6])) / np.abs(c[6])))
        dcf = float(np.abs(g[8] - c[8]).max())
        pose_atol, cam_rtol = POSE_ATOL, CALIB_CAM_RTOL
        print(f"cpu vs cuda, 96x72 self-calibration, {path} ({SMALL_CALIB_FRAMES} frames): "
              f"max |dq| {dq:.3e}, max |dt| {dt:.3e} (atol {pose_atol}); fx..cy max rel "
              f"diff {dcam:.3e} (rtol {cam_rtol}); a diff {abs(g[7] - c[7]):.3e}, cfactor "
              f"max diff {dcf:.3e}; surfels cuda {g[4]['surfels']} cpu {c[4]['surfels']} "
              f"(rel diff {ds:.4f}, limit {SURFEL_RTOL}); CG steps cuda {g[4]['cg_steps']} "
              f"cpu {c[4]['cg_steps']}; cuda launches {g[5]} ({SMI})")
        if not (len(g[2]) == len(c[2]) == SMALL_CALIB_FRAMES and dq <= pose_atol
                and dt <= pose_atol and dcam <= cam_rtol and ds <= SURFEL_RTOL
                and g[5][kernels.GATHER] > 0):
            failed.append(path)
    if failed:
        raise AssertionError(f"CPU and CUDA disagree on the self-calibrating paths {failed}")


def _in_frame() -> bool:
    """Whether the caller runs inside BadSlam.process_frame (a closure
    attempt at a keyframe, not the one after the frame loop)."""
    f = sys._getframe()
    while f is not None:
        if f.f_code is BadSlam.process_frame.__code__:
            return True
        f = f.f_back
    return False


class _LoopProbe:
    """For the duration of a run: each closure attempt's time between CUDA
    events, whether it captured or replayed the attempt's graph, and its
    K2 launches, and each drain's wait for the detection thread on the host
    clock (the front end's methods, wrapped). A graph run's K2 launches
    come from the graph's device counters (read after the run)."""

    def __enter__(self):
        self.attempts, self.frames, self.args, self.waits_ms, self.thread = [], [], [], [], None
        self._orig = (BadSlam._attempt_loop_closure, LoopDetectionThread.wait_through)
        attempt, wait = self._orig
        probe = self

        def timed_attempt(slam, *args):
            graph = slam.closure_graph
            replays = graph.replays if graph is not None else 0
            captures = len(graph.captures) if graph is not None else 0
            h1 = kernels.launch_counts[kernels.TRACK_COEFFS]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            attempt(slam, *args)
            end.record()
            if graph is not None and graph.replays > replays:
                kind = "capture" if len(graph.captures) > captures else "replay"
                run = (graph, replays)
            else:
                kind, run = ("eager" if graph is None else "none"), None
            probe.attempts.append((start, end, kind, run,
                                   kernels.launch_counts[kernels.TRACK_COEFFS] - h1))
            probe.frames.append(slam.last_frame_index if _in_frame() else None)
            probe.args.append(args)

        def timed_wait(thread, seq):
            t0 = time.perf_counter()
            wait(thread, seq)
            probe.waits_ms.append(1000.0 * (time.perf_counter() - t0))
            probe.thread = thread

        BadSlam._attempt_loop_closure = timed_attempt
        LoopDetectionThread.wait_through = timed_wait
        return self

    def __exit__(self, *exc):
        BadSlam._attempt_loop_closure, LoopDetectionThread.wait_through = self._orig

    def attempt_ms(self) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e, *_ in self.attempts]

    def attempt_h1(self) -> list:
        """H1 launches per attempt (the refinements' tracker): a graph run's
        from its device counters, an eager call's as counted at launch."""
        out = []
        for _, _, _, run, host in self.attempts:
            if run is None:
                out.append(host)
            else:
                graph, index = run
                launches = graph.replay_launches()[index]
                out.append(sum(n for (name, _, _), n in launches.items()
                               if name == kernels.TRACK_COEFFS))
        return out


def _attempt_ms_again(slam, args, rounds: int = 2) -> dict:
    """The run's first closure attempt again on its finished state,
    restored before each call: device ms (CUDA events) of `rounds` replays
    of its graph and `rounds` eager calls with the host loop, alternating
    after one untimed replay (a capture if the state's storage changed)."""
    ks, graph = slam.direct_ba.keyframes, slam.closure_graph
    state = (ks.q, ks.t, slam.traj_q, slam.traj_t)
    saved, count = [x.clone() for x in state], slam.loop_closure_count
    ms = {"replay": [], "eager": []}
    for i in range(2 * rounds + 1):
        mode = "replay" if i % 2 == 0 else "eager"
        for dst, src in zip(state, saved):
            dst.copy_(src)
        slam.closure_graph = graph if mode == "replay" else None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        try:
            start.record()
            slam._attempt_loop_closure(*args)
            end.record()
        finally:
            slam.closure_graph = graph
        end.synchronize()
        if i > 0:
            ms[mode].append(start.elapsed_time(end))
    for dst, src in zip(state, saved):
        dst.copy_(src)
    slam.loop_closure_count = count
    return ms


def _endpoint_error(est, gt) -> float:
    """Translation error of the start-to-end motion (test_loop_organic.py)."""
    def rel(a, b):
        return s3.mul(s3.inverse(s3.SE3(np.asarray(a.q, float), np.asarray(a.t, float))),
                      s3.SE3(np.asarray(b.q, float), np.asarray(b.t, float)))
    err = s3.log(s3.mul(s3.inverse(rel(gt[0], gt[-1])), rel(est[0], est[-1])))
    return float(np.linalg.norm(err[:3]))


def _write_loop_sequence(data: str):
    gt = synthetic.loop_trajectory(LOOP_FRAMES, loop_frames=LOOP_AT, orbit_radius=0.4)
    synthetic.write_tum_dataset(
        data, synthetic.default_camera(WIDTH, HEIGHT), synthetic.room_scene(3.5), gt,
        albedo=lambda p: synthetic.textured_intensity_at(p, cell=0.07),
        depth_noise=0.004, depth_bias_quadratic=0.004, intensity_noise=2.0)
    return gt


def loop_off_job(workdir: str) -> int:
    """The loop phase's dataset and its run with loop detection off, in a
    process of its own (start_loop_off) that overlaps phases 5-14."""
    tuner._TUNING_PATH = os.path.join(workdir, "tuning_loop_off.json")  # stays empty
    t0 = time.perf_counter()
    _write_loop_sequence(os.path.join(workdir, "loop"))
    print(f"loop: {LOOP_FRAMES} frames written at {WIDTH}x{HEIGHT} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rc = cli.main([os.path.join(workdir, "loop"), "--device", "cuda", *LOOP_FLAGS,
                   "--enable_loop_detection", "false",
                   "--export_poses", os.path.join(workdir, "loop_off_poses.txt"),
                   "--export_frame_times", os.path.join(workdir, "loop_off_times.json")])
    print(f"loop: the run with loop detection off took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rc


def start_loop_off(workdir: str) -> subprocess.Popen:
    """Starts loop_off_job in a child process, one more host process on the
    card while phases 5-14 run (the frames are launch-bound and leave the
    card mostly idle, but the times of those phases include its share of
    the host and the card). Its output goes to workdir/loop_off.log."""
    log = open(os.path.join(workdir, "loop_off.log"), "w")
    code = "import sys, chip_smoke; sys.exit(chip_smoke.loop_off_job(sys.argv[1]))"
    proc = subprocess.Popen([sys.executable, "-c", code, workdir], stdout=log,
                            stderr=subprocess.STDOUT,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    log.close()
    return proc


def phase_loop(workdir: str, off_job: subprocess.Popen) -> dict:
    """The default main path with loop closure at VGA: the run with loop
    detection on here, against the off run of start_loop_off."""
    rc = off_job.wait()
    with open(os.path.join(workdir, "loop_off.log")) as f:
        off_log = f.read()
    print(off_log.strip())
    if rc != 0:
        raise RuntimeError(f"the loop-off run failed with exit code {rc}")
    data = os.path.join(workdir, "loop")
    gt = synthetic.loop_trajectory(LOOP_FRAMES, loop_frames=LOOP_AT, orbit_radius=0.4)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _LoopProbe() as probe:
        slam, poses, q, t, summary, launches = _run_slam(data, workdir, "loop_on", "cuda",
                                                         LOOP_FLAGS)
    wall_on = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    poses_off, _, _ = _poses(os.path.join(workdir, "loop_off_poses.txt"))
    with open(os.path.join(workdir, "loop_off_times.json")) as f:
        summary_off = json.load(f)
    ate_on, ate_off = synthetic.ate_rmse(poses, gt), synthetic.ate_rmse(poses_off, gt)
    endpoint = _endpoint_error(poses, gt)

    attempts = summary["closure_attempts"]
    applied = [a["frame"] for a in attempts if a["consistent"] and a["needed"]]
    det = slam.loop_detector
    stage = {k: _ms_summary(v) for k, v in det.timings_ms.items()}
    attempt_ms = probe.attempt_ms()
    attempt_h1 = probe.attempt_h1()
    attempt_kinds = [kind for _, _, kind, _, _ in probe.attempts]
    frame_ms = dict(summary["frame_ms"])
    kf_frames = set(summary["keyframe_frames"][1:])
    attempt_frames = {a["frame"] for a in attempts} & kf_frames
    groups = {"keyframe": [frame_ms[i] for i in sorted(kf_frames - attempt_frames)],
              "keyframe with a closure attempt": [frame_ms[i] for i in sorted(attempt_frames)],
              "other": [frame_ms[i] for i in sorted(frame_ms)[1:] if i not in kf_frames]}
    medians = "; ".join(f"{k} frames median {statistics.median(v):.2f} ms ({len(v)})"
                        for k, v in groups.items() if v)
    off_ms = [ms for _, ms in summary_off["frame_ms"][1:]]
    print(f"loop: {LOOP_FRAMES} frames at {WIDTH}x{HEIGHT} on cuda, default config (loop "
          f"detection on the worker thread, parallel BA, a keyframe every 10 frames), "
          f"{wall_on:.1f} s wall; closures {slam.loop_closure_count} "
          f"applied at frames {applied}; attempts {len(probe.attempts)} (rejected by the "
          f"consistency gate {sum(not a['consistent'] for a in attempts)}, by the necessity "
          f"gate {sum(a['consistent'] and not a['needed'] for a in attempts)}, before the gates "
          f"{len(probe.attempts) - len(attempts)}): {attempts}; ATE on {ate_on:.4f} m, off "
          f"{ate_off:.4f} m (ratio {ate_on / ate_off:.3f}, limit {LOOP_ATE_RATIO}); endpoint "
          f"error {endpoint:.4f} m (limit {LOOP_ENDPOINT_M}); Gauss-Newton iterations per "
          f"steady frame {slam.steady_gn_iterations() / (LOOP_FRAMES - 1):.2f}; ({SMI})")
    print(f"loop: features per keyframe {det.feature_counts}; worker ms per keyframe "
          f"{_ms_summary(probe.thread.worker_ms if probe.thread else [])}; by stage {stage}; "
          f"drain waits {_ms_summary(probe.waits_ms)}; per closure attempt "
          f"{_ms_summary(attempt_ms)} between CUDA events, H1 launches {attempt_h1}; "
          f"{medians}; BA iterations per call {summary['ba_iterations']}; keyframes "
          f"{summary['keyframes']}; surfels {summary['surfels']}; loop off (its own process, "
          f"beside phases 5-14): per-frame median {statistics.median(off_ms):.2f} ms; "
          f"peak memory {peak_mb:.1f} MiB; launches {launches} ({SMI})")
    cg = slam.closure_graph
    # Each frame's BA ms: the calls in run order are each frame's drain,
    # then its keyframe call (the first keyframe runs none).
    calls = sorted([(f, 0) for f in summary["ba_drain_frames"]]
                   + [(f, 1) for f in summary["keyframe_frames"][1:]])
    ba_at = {}
    if len(calls) == len(summary["ba_call_ms"]):
        for (f, _), ms in zip(calls, summary["ba_call_ms"]):
            ba_at[f] = ba_at.get(f, 0.0) + ms
    gated = iter(attempts)  # the attempts that reached the gates, in order
    for i, (kind, ms, h1, f) in enumerate(zip(attempt_kinds, attempt_ms, attempt_h1,
                                              probe.frames)):
        gates = None if kind == "none" else next(gated)
        ba = ba_at.get(f, float("nan"))
        where = ("after the frame loop" if f is None else
                 f"the frame {frame_ms[f]:.3f} ms: the attempt, its BA calls {ba:.3f} ms and "
                 f"{frame_ms[f] - ms - ba:.3f} ms of the rest; the next frame "
                 f"{frame_ms.get(f + 1, float('nan')):.3f} ms")
        print(f"loop: closure attempt {i} in frame {f}: {kind}, {ms:.3f} ms between CUDA "
              f"events, H1 launches {h1}, gates {gates}; {where} ({SMI})")
    for c in cg.captures:
        print(f"loop: closure graph (order bucket {c['order_bucket']}, {c['refinements']} "
              f"refinements): capture {c['capture_s']:.3f} s, instantiate "
              f"{c['instantiate_s']:.3f} s, {c['nodes']} nodes ({c['kernel_nodes']} kernel "
              f"nodes, {c['top_kernel_nodes']} outside the bodies of its {c['while_nodes']} "
              f"WHILE nodes), {c['replays']} replays, pools {c['reserved_mib']:.1f} MiB "
              f"({SMI})")
    bag = slam.ba_graph
    print(f"loop: BA graphs: {len(bag.captures)} captures (keyframe / surfel buckets "
          f"{sorted({(c['keyframe_bucket'], c['surfel_bucket']) for c in bag.captures})}), "
          f"capture {sum(c['capture_s'] for c in bag.captures):.2f} s and instantiate "
          f"{sum(c['instantiate_s'] for c in bag.captures):.2f} s in all, {bag.replays} "
          f"replays; keyframe frames median "
          f"{statistics.median([frame_ms[i] for i in sorted(kf_frames)]):.2f} ms "
          f"({len(kf_frames)}); BA ms per call {_ms_median(slam.direct_ba.ba_spans.ms())} "
          f"({SMI})")
    checks = {
        "a closure applied": slam.loop_closure_count >= 1,
        f"none applied by frame {LOOP_AT - 1}": all(f >= LOOP_AT for f in applied),
        "ATE(on) below 0.66 ATE(off)": ate_on < LOOP_ATE_RATIO * ate_off,
        "endpoint error below the limit": endpoint < LOOP_ENDPOINT_M,
        f"{LOOP_FRAMES} poses": len(poses) == len(poses_off) == LOOP_FRAMES,
        "finite poses with loop detection off": bool(np.all(np.isfinite(
            [np.r_[p.q, p.t] for p in poses_off]))),
        "K1 once per frame": launches[kernels.BILATERAL] == LOOP_FRAMES,
        "H1 launched in the refinement": sum(attempt_h1) > 0,
        "every attempt that reached the gates ran its closure graph":
            cg.replays == len(attempts) == sum(k in ("capture", "replay")
                                                 for k in attempt_kinds),
        "the BA calls replayed graphs": bag.replays == len(summary["ba_iterations"]) > 0,
    }
    if probe.args:
        again = _attempt_ms_again(slam, probe.args[0])
        print(f"loop: the first closure attempt again on the finished state, device ms per "
              f"attempt: replays {', '.join(f'{x:.3f}' for x in again['replay'])} / eager "
              f"{', '.join(f'{x:.3f}' for x in again['eager'])} ({SMI})")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"loop checks failed: {failed}")
    return launches


def _injected_closure(data: str, device: str) -> dict:
    """test_loop.py:211 on one device: a candidate whose closure would move
    40 keypoints by under a pixel (rejected by the necessity gate), then
    the same candidate after drift was injected into the last keyframe."""
    slam = BadSlam(BadSlamConfig(**CPU_LOOP_CONFIG), load_tum_dataset(data), device)
    try:
        slam.run()
        ks = slam.direct_ba.keyframes
        last = ks.count - 1

        def host(k):
            return s3.SE3(ks.q[k].double().cpu().numpy(), ks.t[k].double().cpu().numpy())

        true = host(last)
        cur_T_matched = s3.mul(s3.inverse(true), host(0))
        rng = np.random.default_rng(0)
        pts = np.stack([rng.uniform(-0.5, 0.5, 40), rng.uniform(-0.4, 0.4, 40),
                        rng.uniform(1.0, 2.0, 40)], -1).astype(np.float32)
        own = slam.loop_detector.features[last]
        slam.loop_detector.features[last] = own._replace(points_local=pts)
        before = [x.clone() for x in (ks.q, ks.t, slam.traj_q, slam.traj_t)]
        kernels.reset_launch_counts()
        slam._attempt_loop_closure(last, 0, cur_T_matched)
        rejected = slam.closure_attempts[-1]
        untouched = all(torch.equal(a, b) for a, b in
                        zip(before, (ks.q, ks.t, slam.traj_q, slam.traj_t)))
        slam.loop_detector.features[last] = own

        moved = s3.mul(s3.SE3(np.asarray(CPU_LOOP_DRIFT.q, float),
                              np.asarray(CPU_LOOP_DRIFT.t, float)), true)
        ks.set_pose(last, se3.SE3(torch.tensor(moved.q, dtype=torch.float32),
                                  torch.tensor(moved.t, dtype=torch.float32)))
        drift = float(np.linalg.norm(moved.t - true.t))
        slam._attempt_loop_closure(last, 0, cur_T_matched)
        kernels.flush_launch_counts()
        return dict(q=ks.q.cpu().numpy(), t=ks.t.cpu().numpy(),
                    traj_q=slam.traj_q.cpu().numpy(), traj_t=slam.traj_t.cpu().numpy(),
                    closures=slam.loop_closure_count, rejected=rejected, untouched=untouched,
                    drift=drift, after=float(np.linalg.norm(host(last).t - true.t)),
                    h1=kernels.launch_counts[kernels.TRACK_COEFFS],
                    graph_runs=0 if slam.closure_graph is None else slam.closure_graph.replays)
    finally:
        slam.close()


def phase_cpu_loop(workdir: str) -> None:
    data = os.path.join(workdir, "cpu_loop")
    synthetic.write_tum_dataset(data, synthetic.default_camera(128, 96),
                                synthetic.random_plane_scene(np.random.default_rng(3), 6),
                                synthetic.smooth_trajectory(16, scale=0.006))
    g, c = _injected_closure(data, "cuda"), _injected_closure(data, "cpu")
    dk = max(float(np.abs(g[k] - c[k]).max()) for k in ("q", "t"))
    dtraj = max(float(np.abs(g[k] - c[k]).max()) for k in ("traj_q", "traj_t"))
    print(f"cpu vs cuda, injected loop closure (128x96, 16 frames): keyframe poses max diff "
          f"{dk:.3e}, trajectory max diff {dtraj:.3e} (atol {POSE_ATOL}); closures cuda "
          f"{g['closures']} cpu {c['closures']}; last keyframe drift {g['drift']:.4f} m -> "
          f"cuda {g['after']:.4f}, cpu {c['after']:.4f} m; rejected candidate cuda "
          f"{g['rejected']} (poses untouched {g['untouched']}), cpu {c['rejected']} (poses "
          f"untouched {c['untouched']}); H1 launches in the two cuda attempts {g['h1']}, "
          f"closure graph runs {g['graph_runs']} ({SMI})")
    if not (dk <= POSE_ATOL and dtraj <= POSE_ATOL and g["closures"] == c["closures"] == 1
            and g["untouched"] and c["untouched"] and not g["rejected"]["needed"]
            and not c["rejected"]["needed"] and g["after"] < 0.5 * g["drift"] and g["h1"] > 0
            and g["graph_runs"] == 2):
        raise AssertionError("CPU and CUDA disagree on the injected loop closure")


# Phase closure_graph: replay against the eager call, per candidate, in
# this many rounds of (replay, eager).
CLOSURE_GRAPH_ATOL = 1e-6
CLOSURE_ROUNDS = 3


def phase_closure_graph(workdir: str) -> None:
    """Phase 16's injected candidate on the card, on one state restored
    before each attempt: rejected (40 keypoints, no drift) and accepted
    (drift injected) in turn, each as a replay of the attempt's CUDA graph
    and as the eager call of the same function with the host loop; then a
    replayed accepting and rejecting attempt under the sync check."""
    slam = BadSlam(BadSlamConfig(**CPU_LOOP_CONFIG),
                   load_tum_dataset(os.path.join(workdir, "cpu_loop")), "cuda")
    try:
        slam.run()
        ks, det, graph = slam.direct_ba.keyframes, slam.loop_detector, slam.closure_graph
        last = ks.count - 1

        def host(k):
            return s3.SE3(ks.q[k].double().cpu().numpy(), ks.t[k].double().cpu().numpy())

        true = host(last)
        cur_T_matched = s3.mul(s3.inverse(true), host(0))
        moved = s3.mul(s3.SE3(np.asarray(CPU_LOOP_DRIFT.q, float),
                              np.asarray(CPU_LOOP_DRIFT.t, float)), true)
        moved = se3.SE3(torch.tensor(moved.q, dtype=torch.float32),
                        torch.tensor(moved.t, dtype=torch.float32))
        rng = np.random.default_rng(0)
        pts = np.stack([rng.uniform(-0.5, 0.5, 40), rng.uniform(-0.4, 0.4, 40),
                        rng.uniform(1.0, 2.0, 40)], -1).astype(np.float32)
        own = det.features[last]
        state = (ks.q, ks.t, slam.traj_q, slam.traj_t)
        saved = [x.clone() for x in state]

        def attempt(accept: bool, replay: bool, sync_check: bool = False) -> dict:
            for dst, src in zip(state, saved):
                dst.copy_(src)
            slam.loop_closure_count = 0
            if accept:
                ks.set_pose(last, moved)
            else:
                det.features[last] = own._replace(points_local=pts)
            before = [x.clone() for x in state]
            slam.closure_graph = graph if replay else None
            kernels.reset_launch_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            try:
                if sync_check:
                    torch.cuda.set_sync_debug_mode("error")
                start.record()
                slam._attempt_loop_closure(last, 0, cur_T_matched)
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
                det.features[last] = own
                slam.closure_graph = graph
            end.synchronize()
            kernels.flush_launch_counts()
            a = slam.closure_attempts[-1]
            return dict(ms=start.elapsed_time(end), before=before,
                        after=[x.clone() for x in state], gates=(a["consistent"], a["needed"]),
                        count=slam.loop_closure_count,
                        h1=kernels.launch_counts[kernels.TRACK_COEFFS])

        capture = attempt(True, True)
        runs = {(accept, replay): [] for accept in (False, True) for replay in (True, False)}
        for _ in range(CLOSURE_ROUNDS):
            for accept in (False, True):
                for replay in (True, False):
                    runs[accept, replay].append(attempt(accept, replay))
        replays_before = graph.replays
        synced = [attempt(accept, True, sync_check=True) for accept in (True, False)]
    finally:
        slam.close()
    failed = []
    for accept in (False, True):
        name = "accepted" if accept else "rejected"
        g, e = runs[accept, True], runs[accept, False]
        dq = max(float((a["after"][i] - b["after"][i]).abs().max())
                 for a in g for b in e for i in (0, 2))
        dt = max(float((a["after"][i] - b["after"][i]).abs().max())
                 for a in g for b in e for i in (1, 3))
        gates = {r["gates"] for r in g + e}
        h1 = {r["h1"] for r in g + e}
        counts = {r["count"] for r in g + e}
        print(f"closure_graph ({SMI}): the {name} candidate (128x96, 3 scales), replay / "
              f"eager: device ms per attempt {_ms_summary([r['ms'] for r in g])} / "
              f"{_ms_summary([r['ms'] for r in e])}; keyframe poses and trajectory max |dq| "
              f"{dq:.3e}, |dt| {dt:.3e} (atol {CLOSURE_GRAPH_ATOL}); gates {sorted(gates)}; "
              f"H1 launches per attempt {sorted(h1)}; closures {sorted(counts)}")
        if not (dq <= CLOSURE_GRAPH_ATOL and dt <= CLOSURE_GRAPH_ATOL):
            failed.append(f"{name}: replay and eager poses differ")
        if gates != {(True, accept)} or counts != {int(accept)}:
            failed.append(f"{name}: gates {gates}, closures {counts}")
        if len(h1) != 1 or 0 in h1:
            failed.append(f"{name}: H1 launches {h1}")
        if not accept and not all(torch.equal(a, b) for r in g
                                  for a, b in zip(r["before"], r["after"])):
            failed.append("a replayed rejection moved a pose")
    for c in graph.captures:
        print(f"  closure graph (order bucket {c['order_bucket']}, {c['refinements']} "
              f"refinements): capture {c['capture_s']:.3f} s, instantiate "
              f"{c['instantiate_s']:.3f} s, {c['nodes']} nodes ({c['kernel_nodes']} kernel "
              f"nodes: {c['top_kernel_nodes']} outside the bodies of its {c['while_nodes']} "
              f"WHILE nodes, per body {c['body_kernel_nodes']}), {c['replays']} replays, pools "
              f"{c['reserved_mib']:.1f} MiB; the capturing attempt {capture['ms']:.3f} ms "
              f"between CUDA events")
    print(f"  under set_sync_debug_mode('error'): a replayed accepting and a replayed "
          f"rejecting attempt, gates {[r['gates'] for r in synced]}, "
          f"{graph.replays - replays_before} replays, no sync")
    if len(graph.captures) != 1 or graph.replays - replays_before != 2:
        failed.append(f"captures {len(graph.captures)}, sync-check replays "
                      f"{graph.replays - replays_before}")
    if [r["gates"] for r in synced] != [(True, True), (True, False)]:
        failed.append(f"sync-check gates {[r['gates'] for r in synced]}")
    if failed:
        raise AssertionError(f"closure_graph checks failed: {failed}")


# Live input (phases 17-21): the slice's 30 VGA frames arrive at 30 FPS.
LIVE_FPS = 30.0


def _stream_names(n: int):
    return [f"{i / LIVE_FPS:.6f}.png" for i in range(n)]


def _stream_dir(path: str, calibration: str) -> None:
    os.makedirs(os.path.join(path, "depth"))
    os.makedirs(os.path.join(path, "rgb"))
    with open(calibration) as src, open(os.path.join(path, "calibration.txt"), "w") as dst:
        dst.write(src.read())


def _dataset_pngs(data: str):
    """The PNG bytes of a written dataset's frames: [(depth, rgb)]."""
    with open(os.path.join(data, "associated.txt")) as f:
        rows = [line.split() for line in f if line.strip()]
    out = []
    for row in rows:
        with open(os.path.join(data, row[3]), "rb") as fd, \
                open(os.path.join(data, row[1]), "rb") as fc:
            out.append((fd.read(), fc.read()))
    return out


def _directory_writer(path: str, pngs) -> threading.Thread:
    """A camera process dropping each frame's PNG pair (written by
    io/png.py) into `path` at LIVE_FPS, then `end`."""
    def write():
        t0 = time.perf_counter()
        for i, (name, (depth, rgb)) in enumerate(zip(_stream_names(len(pngs)), pngs)):
            time.sleep(max(0.0, t0 + i / LIVE_FPS - time.perf_counter()))
            with open(os.path.join(path, "depth", name), "wb") as f:
                f.write(depth)
            with open(os.path.join(path, "rgb", name), "wb") as f:
                f.write(rgb)
        open(os.path.join(path, "end"), "w").close()

    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


class _SnapshotProbe:
    """For the duration of a run: the host ms of each live-viewer snapshot
    (device reads included: a snapshot synchronizes)."""

    def __enter__(self):
        self.ms = []
        self._orig = LiveViewer.snapshot
        orig, probe = self._orig, self

        def timed(viewer, slam):
            t0 = time.perf_counter()
            orig(viewer, slam)
            probe.ms.append(1000.0 * (time.perf_counter() - t0))

        LiveViewer.snapshot = timed
        return self

    def __exit__(self, *exc):
        LiveViewer.snapshot = self._orig


def _lag_summary(summary) -> str:
    lag = np.array([ms for _, ms in summary["live_lag_ms"]])
    return (f"capture-to-pose lag median {np.median(lag):.1f} ms, p90 "
            f"{np.percentile(lag, 90):.1f} ms, max {lag.max():.1f} ms; largest backlog "
            f"{max(summary['live_backlog'])} frames")


def _decode_ms(path: str, reader) -> float:
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        reader(path)
        times.append(1000.0 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_live(workdir: str, data: str) -> tuple:
    """The slice's 30 VGA frames written into a directory at 30 FPS while
    `cli.run --live dir:` follows it on cuda with the live viewer (a
    snapshot per keyframe, on a free port) and the HTML export."""
    gt = synthetic.smooth_trajectory(FRAMES)
    path = os.path.join(workdir, "live_dir")
    _stream_dir(path, os.path.join(data, "calibration.txt"))
    pngs = _dataset_pngs(data)
    view = os.path.join(workdir, "live_view")
    html = os.path.join(workdir, "live_map.html")
    torch.cuda.reset_peak_memory_stats()
    writer = _directory_writer(path, pngs)
    t0 = time.perf_counter()
    with _SnapshotProbe() as probe:
        slam, poses, q, t, summary, launches = _run_slam(
            ["--live", f"dir:{path}"], workdir, "live", "cuda",
            SLICE_FLAGS + ["--live_viewer_dir", view, "--live_viewer_port", "0",
                           "--live_viewer_interval", "1", "--export_viewer", html])
    wall = time.perf_counter() - t0
    writer.join(timeout=60)
    shapes = _shapes()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ate = synthetic.ate_rmse(poses, gt)
    names = _stream_names(FRAMES)
    depth_ms = _decode_ms(os.path.join(path, "depth", names[0]), _imread_depth)
    color_ms = _decode_ms(os.path.join(path, "rgb", names[0]), _imread_color)
    with open(os.path.join(view, "map_data.json")) as f:
        generation = json.load(f)["generation"]
    with open(html) as f:
        html_text = f.read()
    keyframes = len(summary["keyframe_frames"])
    print(f"live (dir): {FRAMES} frames at {WIDTH}x{HEIGHT} arriving at {LIVE_FPS:.0f} FPS "
          f"on cuda, {wall:.1f} s wall; ATE {ate:.3e} m (limit {ATE_LIMIT_M}); "
          f"{_frame_medians(summary)}; {_lag_summary(summary)}; PNG decode per VGA frame "
          f"(host, median of 10) depth {depth_ms:.2f} ms, color {color_ms:.2f} ms with "
          f"{native_loader.decoder_name()}; viewer snapshots {len(probe.ms)} "
          f"({_ms_summary(probe.ms)}), map_data.json generation {generation}, HTML "
          f"{len(html_text)} bytes written in {summary['export_viewer_s'] * 1000:.1f} ms; "
          f"keyframes {keyframes}; BA iterations per call {summary['ba_iterations']}; "
          f"surfels {summary['surfels']}; peak memory {peak_mb:.1f} MiB; launches "
          f"{launches}; K1 shapes {shapes[kernels.BILATERAL]} ({SMI})")
    checks = {
        f"{FRAMES} frames processed": len(poses) == len(summary["frame_ms"]) == FRAMES,
        "K1 once per frame at 480x640, default tile":
            shapes[kernels.BILATERAL] == {(HEIGHT, WIDTH, _default_tile()): FRAMES},
        "K2 launched": launches[kernels.GATHER] > 0,
        "ATE below the limit": ate < ATE_LIMIT_M,
        "a snapshot per keyframe and a final one":
            generation == len(probe.ms) == keyframes + 1 and keyframes >= 3,
        "HTML above 10 kB with kf_poses": len(html_text) > 10_000 and '"kf_poses"' in html_text,
        "a lag per frame": len(summary["live_lag_ms"]) == FRAMES,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"live checks failed: {failed}")
    return slam, q, t, launches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_tcp(workdir: str, data: str, q_dir, t_dir) -> None:
    """The same 30 frames sent with send_frame at 30 FPS to `cli.run --live
    tcp:<port>`; poses held to the directory run."""
    video = load_tum_dataset(data)
    frames = [(video.depth_u16(i), video.color_u8(i)) for i in range(FRAMES)]
    port = _free_port()
    sent = []

    def client():
        deadline = time.monotonic() + 60.0
        while True:  # the CLI opens the port once it has parsed its flags
            try:
                sock = socket.create_connection(("127.0.0.1", port), timeout=5)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        with sock:
            t0 = time.perf_counter()
            for i, (depth, rgb) in enumerate(frames):
                time.sleep(max(0.0, t0 + i / LIVE_FPS - time.perf_counter()))
                live_inputs.send_frame(sock, i / LIVE_FPS, depth, rgb, video.camera)
                sent.append(i)

    sender = threading.Thread(target=client, daemon=True)
    sender.start()
    t0 = time.perf_counter()
    _, poses, q, t, summary, launches = _run_slam(
        ["--live", f"tcp:{port}"], workdir, "live_tcp", "cuda", SLICE_FLAGS)
    wall = time.perf_counter() - t0
    sender.join(timeout=60)
    dq, dt = float(np.abs(q - q_dir).max()), float(np.abs(t - t_dir).max())
    print(f"live (tcp): {len(sent)} frames sent at {LIVE_FPS:.0f} FPS, {len(poses)} "
          f"processed on cuda in {wall:.1f} s wall; against the directory run max |dq| "
          f"{dq:.3e}, max |dt| {dt:.3e} (atol {POSE_ATOL}); {_frame_medians(summary)}; "
          f"{_lag_summary(summary)}; launches {launches} ({SMI})")
    if not (len(sent) == len(poses) == FRAMES and dq <= POSE_ATOL and dt <= POSE_ATOL
            and launches[kernels.BILATERAL] == FRAMES):
        raise AssertionError("the TCP stream disagrees with the directory stream")


def phase_viewer_controls(workdir: str, slam) -> None:
    """tests/test_viewer.py:140-185 on the card: commands sent over HTTP
    /control to a LiveViewer on a free port, applied on this thread by the
    front end, on the finished directory run's state."""
    viewer = LiveViewer(os.path.join(workdir, "controls"), port=0, interval=1)
    slam.live_viewer = viewer
    ba, ks = slam.direct_ba, slam.direct_ba.keyframes
    base = f"http://127.0.0.1:{viewer.port}/control?cmd="

    def send(*cmds) -> float:
        """Queue the commands over HTTP and apply them; the host ms to
        apply (BA, densify, snapshots; synchronized)."""
        for cmd in cmds:
            urllib.request.urlopen(base + urllib.parse.quote(cmd), timeout=10).read()
        t0 = time.perf_counter()
        viewer.wait_if_paused(on_wake=slam._apply_viewer_commands)
        torch.cuda.synchronize()
        return 1000.0 * (time.perf_counter() - t0)

    try:
        calls, surfels, gen = len(ba.iterations_run), ba.surfel_count, viewer.generation
        ms_ba = send("ba")
        ms_densify = send("densify")
        send("set:keyframe_interval=5", "set:max_surfel_count=1")
        slot = next(s for s in ks.live_slots_in_time_order() if s != slam.base_kf_id)
        before = ks.t[slot].cpu().clone()
        ms_move = send(f"move_kf:{slot}:0.05,0,0")
        moved = (ks.t[slot].cpu() - before).numpy()
        live = ks.live_count
        ms_delete = send(f"delete_kf:{slot}")
        after_delete, gen_commands = ks.live_count, viewer.generation
        q0, t0_, live0 = ks.q.clone(), ks.t.clone(), ks.live_count
        send(f"delete_kf:{slam.base_kf_id}", "move_kf:banana", "delete_kf:xyz",
             "move_kf:99:1,0,0", "set:keyframe_interval=x")
        unchanged = (torch.equal(ks.q, q0) and torch.equal(ks.t, t0_)
                     and ks.live_count == live0 and slam.config.keyframe_interval == 5)
    finally:
        viewer.close()
        slam.live_viewer = None
    print(f"viewer controls over HTTP on cuda: ba {ms_ba:.1f} ms ({ba.iterations_run[calls]} "
          f"iterations), densify {ms_densify:.1f} ms (surfels {surfels} -> {ba.surfel_count}), "
          f"move_kf {ms_move:.1f} ms (slot {slot} moved by {moved}), delete_kf {ms_delete:.1f} "
          f"ms (live keyframes {live} -> {after_delete}), each with its snapshot; "
          f"generation {gen} -> {gen_commands}; refused commands left the state "
          f"unchanged: {unchanged} ({SMI})")
    checks = {
        "BA ran": len(ba.iterations_run) == calls + 1,
        "densify added surfels": ba.surfel_count > surfels,
        "config edited through the whitelist": (slam.config.keyframe_interval == 5
                                                and slam.config.max_surfel_count != 1),
        "keyframe moved 0.05 m": abs(moved[0] - 0.05) < 1e-6 and np.abs(moved[1:]).max() < 1e-6,
        "live count dropped by one": after_delete == live - 1,
        "a snapshot per command but set:": gen_commands == gen + 4,
        "base delete and malformed commands changed nothing": unchanged,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"viewer control checks failed: {failed}")


def phase_cpu_live(workdir: str) -> None:
    """phase_cpu's 160x120 sequence as a finished directory stream through
    `cli.run --live dir:` on the card and on the CPU."""
    small = os.path.join(workdir, "small")
    path = os.path.join(workdir, "small_live")
    _stream_dir(path, os.path.join(small, "calibration.txt"))
    for name, (depth, rgb) in zip(_stream_names(SMALL_FRAMES), _dataset_pngs(small)):
        with open(os.path.join(path, "depth", name), "wb") as f:
            f.write(depth)
        with open(os.path.join(path, "rgb", name), "wb") as f:
            f.write(rgb)
    open(os.path.join(path, "end"), "w").close()
    runs = {dev: _run(["--live", f"dir:{path}"], workdir, f"small_live_{dev}", dev, SMALL_FLAGS)
            for dev in ("cuda", "cpu")}
    (_, qg, tg, sg, lg), (_, qc, tc, sc, _) = runs["cuda"], runs["cpu"]
    dq, dt = float(np.abs(qg - qc).max()), float(np.abs(tg - tc).max())
    ds = abs(sg["surfels"] - sc["surfels"]) / max(sc["surfels"], 1)
    print(f"cpu vs cuda, live 160x120 BA stream ({SMALL_FRAMES} frames): max |dq| {dq:.3e}, "
          f"max |dt| {dt:.3e} (atol {POSE_ATOL}); surfels cuda {sg['surfels']} cpu "
          f"{sc['surfels']} (rel diff {ds:.4f}, limit {SURFEL_RTOL}); cuda launches {lg} ({SMI})")
    if not (len(qg) == len(qc) == SMALL_FRAMES and dq <= POSE_ATOL and dt <= POSE_ATOL
            and ds <= SURFEL_RTOL):
        raise AssertionError("CPU and CUDA disagree on the live stream")


def phase_sdk() -> None:
    """The vendor-SDK inputs refuse to start without their SDK."""
    messages = {}
    for spec in ("realsense", "k4a", "structure"):
        try:
            live_inputs.open_live_input(spec, BadSlamConfig()).start()
        except RuntimeError as e:
            messages[spec] = str(e)
        else:
            raise AssertionError(f"the {spec} input started without its SDK")
    print(f"sdk inputs: {messages} ({SMI})")
    if not all("requires its SDK" in m for m in messages.values()):
        raise AssertionError("an SDK input refused with another error")


# Multi-device BA (phases 22-23): two shards, on two cards when visible.
MULTI_SHARDS = 2


def _multi_mesh():
    cards = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(MULTI_SHARDS)] if cards >= MULTI_SHARDS
               else ["cuda:0"] * MULTI_SHARDS)
    return make_mesh(devices=devices), cards


def _ms_median(values) -> str:
    return f"{statistics.median(values):.2f}" if values else "n/a"


def _capture_lines(bag) -> list:
    """One line per capture record of a BAGraph."""
    return [f"  BA graph (shards {c['shards']}, streamed {c['streamed']}, scheme-end first "
            f"{c['end_first']}, last {c['end_last']}, keyframe bucket {c['keyframe_bucket']}, "
            f"surfel bucket {c['surfel_bucket']}): capture {c['capture_s']:.3f} s, "
            f"instantiate {c['instantiate_s']:.3f} s, {c['nodes']} nodes ("
            f"{c['kernel_nodes']} kernel nodes: {c['top_kernel_nodes']} outside the bodies "
            f"of its {c['while_nodes']} WHILE nodes), {c['replays']} replays, pools "
            f"{c['reserved_mib']:.1f} MiB" for c in bag.captures]


def phase_multi(workdir: str, data: str, q_slice, t_slice, slice_summary) -> tuple:
    """The slice through `cli.run` with BA over a 2-shard mesh, planes
    replicated and streamed, held to the single-device slice: with both
    shards on the one card, every BA call a replay of its CUDA graph. Then
    the dry run of every mode on four shards of cuda:0. Returns the launch
    counts and the finished front ends (for phase mesh_graph)."""
    mesh, cards = _multi_mesh()
    print(f"multi: mesh {mesh} ({cards} card(s) visible"
          f"{'' if cards >= MULTI_SHARDS else ': both shards on cuda:0'}); the slice's "
          f"BA ms per call {_ms_median(slice_summary['ba_call_ms'])} (median of "
          f"{len(slice_summary['ba_call_ms'])}), surfels {slice_summary['surfels']} ({SMI})")
    gt = synthetic.smooth_trajectory(FRAMES)
    out, slams = {}, {}
    for mode, extra in (("integrated", []),
                        ("streamed", ["--plane_replication_budget_mb", "0"])):
        held = {}
        for dev in mesh.distinct():
            torch.cuda.reset_peak_memory_stats(dev)
            held[str(dev)] = torch.cuda.memory_allocated(dev) / 2**20
        slam, poses, q, t, summary, launches = _run_slam(
            data, workdir, f"multi_{mode}", "cuda",
            SLICE_FLAGS + ["--n_devices", str(MULTI_SHARDS), *extra], mesh=mesh)
        k2 = {tag: n for tag, n in kernels.launch_tags[kernels.GATHER].items()
              if tag is not None}
        ba = slam.direct_ba
        planes = ba._planes
        plane_bytes = [planes.nbytes(i) for i in range(mesh.size)]
        peak = ", ".join(
            f"{d} {torch.cuda.max_memory_allocated(d) / 2**20:.1f} MiB "
            f"({torch.cuda.max_memory_allocated(d) / 2**20 - held[str(d)]:.1f} above the "
            f"{held[str(d)]:.1f} held at its start)" for d in mesh.distinct())
        ate = synthetic.ate_rmse(poses, gt)
        dq, dt = float(np.abs(q - q_slice).max()), float(np.abs(t - t_slice).max())
        print(f"multi {mode}: streaming {ba._streaming}; ATE {ate:.3e} m; against the "
              f"single-device slice max |dq| {dq:.3e}, max |dt| {dt:.3e} (atol "
              f"{POSE_ATOL}); surfels {summary['surfels']} (slice "
              f"{slice_summary['surfels']}); {_frame_medians(summary)}; BA ms per call "
              f"{_ms_median(summary['ba_call_ms'])} (median of "
              f"{len(summary['ba_call_ms'])}; calls "
              f"{', '.join(f'{x:.1f}' for x in summary['ba_call_ms'])}); BA iterations "
              f"{summary['ba_iterations']}; K2 launches per shard {k2}; plane bytes per "
              f"shard {plane_bytes} ({[planes.keyframes_held(i) for i in range(mesh.size)]}"
              f" keyframe slots of {ba.keyframes.capacity}); peak memory {peak}; launches "
              f"{launches} ({SMI})")
        bag = slam.ba_graph
        if bag is None:
            print(f"multi {mode}: the shards are on several cards, so the BA calls ran "
                  f"eagerly (the logged route) ({SMI})")
        else:
            print(f"multi {mode}: {bag.replays} BA calls as graph replays, "
                  f"{len(bag.captures)} captures ({SMI})")
            print("\n".join(_capture_lines(bag)))
        replayed = bag is None or (bag.replays == len(ba.iterations_run) > 0
                                   and all(c["shards"] == MULTI_SHARDS for c in bag.captures))
        checks = {
            "streaming as asked": ba._streaming == (mode == "streamed"),
            "every BA call replayed over the mesh": replayed,
            "poses within atol of the slice": dq <= POSE_ATOL and dt <= POSE_ATOL,
            "surfels equal to the slice's": summary["surfels"] == slice_summary["surfels"],
            "K1 once per frame": launches[kernels.BILATERAL] == FRAMES,
            "K2 on every shard": all(k2.get(i, 0) > 0 for i in range(mesh.size)),
            f"{FRAMES} poses": len(poses) == FRAMES,
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"multi {mode} checks failed: {failed}")
        out[mode] = {"K1": launches[kernels.BILATERAL], "K2": launches[kernels.GATHER],
                     "K2 per shard": k2}
        slams[mode] = slam
        del slam, ba, planes, bag
    t0 = time.perf_counter()
    result = dryrun_multichip(4, devices=[torch.device("cuda", 0)] * 4)
    torch.cuda.synchronize()
    print(f"multi dryrun_multichip(4) on 4 shards of cuda:0 in "
          f"{time.perf_counter() - t0:.2f} s: {result} ({SMI})")
    return out, slams


# The state a BA call writes: the keyframes' and the map's tensors.
_BA_STATE = ("q", "t", "activation", "last_active_iter", "last_covis_iter")
MESH_GRAPH_ROUNDS = 3


def _saved_ba_state(ba) -> tuple:
    return ([getattr(ba.keyframes, n).clone() for n in _BA_STATE],
            [x.clone() for x in ba.surfels], ba.last_ba_iteration_count)


def _restore_ba_state(ba, saved) -> None:
    """Back to a saved state, in place (the graphs' storage stays)."""
    kf, smap, last = saved
    for n, x in zip(_BA_STATE, kf):
        getattr(ba.keyframes, n).copy_(x)
    for dst, x in zip(ba.surfels, smap):
        dst.copy_(x)
    ba.last_ba_iteration_count = last


# The hand kernels of a BA call's shard work: K2 (creation, merge,
# deletion), H2 (poses) and H3 (geometry, which reads its planes itself).
MESH_KERNELS = (kernels.GATHER, kernels.POSE_COEFFS, kernels.GEOMETRY_NORMALS,
                kernels.GEOMETRY_POSITION)


def _mesh_drain(slam, graph: bool) -> dict:
    """One drain call of 2 iterations over the mesh: a replay of its graph
    or the eager call of the same function (host loops). Device ms between
    CUDA events, iterations, the BA hand kernels' launches per shard (K2,
    H2, H3: each shard's work), poses."""
    ba = slam.direct_ba
    kernels.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    iterations = ba.bundle_adjustment(max_iterations=2, increase_ba_iteration_count=False,
                                      loop=slam.ba_loop,
                                      graph=slam.ba_graph if graph else None)
    end.record()
    end.synchronize()
    kernels.flush_launch_counts()
    return dict(ms=start.elapsed_time(end), iterations=int(iterations),
                shards={tag: sum(kernels.launch_tags[name][tag] for name in MESH_KERNELS)
                        for tag in {t for name in MESH_KERNELS
                                    for t in kernels.launch_tags[name] if t is not None}},
                q=ba.keyframes.q.clone(), t=ba.keyframes.t.clone(),
                surfels=ba.surfel_count)


def phase_mesh_graph(slams: dict) -> None:
    """On the finished state of each layout of phase multi: drain calls over
    the 2-shard mesh as replays of their graph against the eager call of
    the same function, alternating from one restored state, for
    MESH_GRAPH_ROUNDS rounds; then a replayed drain under
    set_sync_debug_mode("error")."""
    for mode, slam in slams.items():
        bag, ba = slam.ba_graph, slam.direct_ba
        if bag is None:
            print(f"mesh_graph {mode}: the shards are on several cards; their BA calls run "
                  f"eagerly (the logged route), nothing to compare ({SMI})")
            continue
        for _ in range(2):  # both drain kinds captured (a new epoch's, then the next)
            _mesh_drain(slam, True)
        captures = len(bag.captures)
        rounds = []
        for _ in range(MESH_GRAPH_ROUNDS):
            saved = _saved_ba_state(ba)
            g = _mesh_drain(slam, True)
            _restore_ba_state(ba, saved)
            e = _mesh_drain(slam, False)
            rounds.append((g, e))
        dq = max(float((g["q"] - e["q"]).abs().max()) for g, e in rounds)
        dt = max(float((g["t"] - e["t"]).abs().max()) for g, e in rounds)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ba.bundle_adjustment(max_iterations=2, increase_ba_iteration_count=False,
                                 loop=slam.ba_loop, graph=bag)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        replay_ms = ", ".join(f"{g['ms']:.3f}" for g, _ in rounds)
        eager_ms = ", ".join(f"{e['ms']:.3f}" for _, e in rounds)
        print(f"mesh_graph {mode} ({SMI}): {MESH_GRAPH_ROUNDS} rounds of a drain of 2 "
              f"iterations over the 2-shard mesh, replay / eager from one state: device ms "
              f"per call {replay_ms} / {eager_ms}; max |dq| {dq:.3e}, "
              f"|dt| {dt:.3e} (atol {BA_GRAPH_ATOL}); iterations "
              f"{[g['iterations'] for g, _ in rounds]} / "
              f"{[e['iterations'] for _, e in rounds]}; "
              f"K2, H2 and H3 launches per shard {[g['shards'] for g, _ in rounds]} / "
              f"{[e['shards'] for _, e in rounds]}; surfels {rounds[-1][0]['surfels']} / "
              f"{rounds[-1][1]['surfels']}; captures {len(bag.captures) - captures} new; then "
              f"a replayed drain under set_sync_debug_mode('error'): no sync")
        checks = {
            "replays equal the eager calls": dq <= BA_GRAPH_ATOL and dt <= BA_GRAPH_ATOL,
            "iterations equal": all(g["iterations"] == e["iterations"] for g, e in rounds),
            "hand-kernel launches per shard equal, on both shards": all(
                g["shards"] == e["shards"]
                and all(g["shards"].get(i, 0) > 0 for i in range(MULTI_SHARDS))
                for g, e in rounds),
            "surfel counts equal": all(g["surfels"] == e["surfels"] for g, e in rounds),
            "the rounds replayed": len(bag.captures) == captures,
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"mesh_graph {mode} checks failed: {failed}")


def phase_cpu_multi(workdir: str) -> None:
    """phase_cpu's 160x120 sequence with BA over a 2-shard mesh on the card
    and a 2-shard mesh on the CPU, planes replicated and streamed."""
    small = os.path.join(workdir, "small")
    mesh, _ = _multi_mesh()
    for mode, extra in (("integrated", []),
                        ("streamed", ["--plane_replication_budget_mb", "0"])):
        flags = SMALL_FLAGS + ["--n_devices", str(MULTI_SHARDS), *extra]
        (_, qg, tg, sg, lg), (_, qc, tc, sc, _) = (
            _run(small, workdir, f"small_multi_{mode}_cuda", "cuda", flags, mesh),
            _run(small, workdir, f"small_multi_{mode}_cpu", "cpu", flags))
        dq, dt = float(np.abs(qg - qc).max()), float(np.abs(tg - tc).max())
        ds = abs(sg["surfels"] - sc["surfels"]) / max(sc["surfels"], 1)
        print(f"cpu vs cuda, 2-shard mesh {mode}, 160x120 BA ({SMALL_FRAMES} frames): max "
              f"|dq| {dq:.3e}, max |dt| {dt:.3e} (atol {POSE_ATOL}); surfels cuda "
              f"{sg['surfels']} cpu {sc['surfels']} (rel diff {ds:.4f}, limit "
              f"{SURFEL_RTOL}); cuda launches {lg} ({SMI})")
        if not (len(qg) == len(qc) == SMALL_FRAMES and dq <= POSE_ATOL and dt <= POSE_ATOL
                and ds <= SURFEL_RTOL):
            raise AssertionError(f"CPU and CUDA disagree on the {mode} mesh")


# Timing rows (phase 24): the stage rows of --save_timings under
# --sync_stage_profiling, in the JAX package's order.
STAGE_ROWS = ("BA_surfel_creation", "BA_surfel_activation", "BA_geometry_optimization",
              "BA_surfel_merge", "BA_surfel_compaction", "BA_pose_optimization")
# A call's stages are timed inside its own span (ba_call_ms), each between
# two of its events: their sum may pass the span only by rounding.
STAGE_SUM_SLACK_MS = 1.0
ATE_DEVICE_RTOL = 1e-6
# The staged run's ATE on the slice: about 3x its reading of 4.7e-5 m (NVIDIA
# H100 80GB HBM3, 700 W). Its every-iteration BA leaves its poses more than
# POSE_ATOL from the unflagged run's, so this limit holds it instead.
STAGED_ATE_LIMIT_M = 1.5e-4


def _parse_rows(path: str) -> list:
    """A --save_timings file as BA calls, in order: per call its header
    fields and, for staged rows, the stage ms of each iteration (None for a
    fused row). Raises on any line that is not a well-formed row in place."""
    calls = []

    def bad(n, line, why):
        return ValueError(f"{path}:{n}: {why}: {line.rstrip()!r}")

    with open(path) as f:
        for n, line in enumerate(f, 1):
            words = line.split()
            if words and words[0] == "BA_count" and len(words) % 2 == 0:
                try:
                    fields = {k: float(v) if k == "sync_ms" else int(v)
                              for k, v in zip(words[::2], words[1::2])}
                except ValueError:
                    raise bad(n, line, "a field is not a number") from None
                keys = list(fields)
                if keys == ["BA_count", "fused_iterations", "keyframe_count",
                            "surfel_bound", "sync_ms"]:
                    calls.append({"header": fields, "iterations": None})
                elif keys == ["BA_count", "inner_iteration", "keyframe_count", "surfel_bound"]:
                    i = fields["inner_iteration"]
                    if i == 0:
                        calls.append({"header": fields, "iterations": []})
                    elif not calls or calls[-1]["iterations"] is None \
                            or len(calls[-1]["iterations"]) != i:
                        raise bad(n, line, "iterations out of order")
                    calls[-1]["iterations"].append({})
                else:
                    raise bad(n, line, "unknown header")
            elif len(words) == 2 and words[0] in STAGE_ROWS:
                if not calls or not calls[-1]["iterations"] \
                        or words[0] in calls[-1]["iterations"][-1]:
                    raise bad(n, line, "a stage row out of place")
                calls[-1]["iterations"][-1][words[0]] = float(words[1])
            else:
                raise bad(n, line, "not a timing row")
    for call in calls:
        for it in call["iterations"] or ():
            if tuple(it) != STAGE_ROWS:
                raise ValueError(f"{path}: an iteration without all six stages: {it}")
    return calls


def phase_timings(workdir: str, data: str, q_slice, t_slice) -> dict:
    """The slice through `cli.run` with --save_timings, once under
    --sync_stage_profiling (every stage ended by a device sync, every BA
    iteration run) and once without, each with --export_final_timings;
    then the device ATE, evaluate_ate on the exported poses, and the staged
    rows on the card against the CPU on phase 7's 160x120 sequence."""
    gt = synthetic.smooth_trajectory(FRAMES)
    runs = {}
    for tag, extra in (("staged", ["--sync_stage_profiling", "true"]), ("fused", [])):
        rows, report = (os.path.join(workdir, f"timings_{tag}.{x}") for x in ("txt", "report"))
        slam, poses, q, t, summary, launches = _run_slam(
            data, workdir, f"timings_{tag}", "cuda",
            SLICE_FLAGS + extra + ["--save_timings", rows, "--export_final_timings", report])
        with open(report) as f:
            timers = {line[:44].rstrip(): float(line[44:].split()[1])
                      for line in f.read().splitlines()[1:]}
        runs[tag] = dict(slam=slam, poses=poses, q=q, t=t, summary=summary,
                         launches=launches, calls=_parse_rows(rows), timers=timers)
    staged, fused = runs["staged"], runs["fused"]
    failed = []
    for tag, run in runs.items():
        calls_ms = run["summary"]["ba_call_ms"]
        if len(run["calls"]) != len(calls_ms):
            failed.append(f"{tag}: {len(run['calls'])} row calls for {len(calls_ms)} BA calls")
        if any((c["iterations"] is None) != (tag == "fused") for c in run["calls"]):
            failed.append(f"{tag}: rows of the other mode")

    # Per stage: its ms in each call (summed over the call's iterations),
    # the median over calls, and the median of its rows.
    per_call = {s: [sum(it[s] for it in c["iterations"]) for c in staged["calls"]]
                for s in STAGE_ROWS}
    per_row = {s: [it[s] for c in staged["calls"] for it in c["iterations"]]
               for s in STAGE_ROWS}
    print(f"timings staged: {len(staged['calls'])} BA calls, "
          f"{sum(len(c['iterations']) for c in staged['calls'])} iterations (every one "
          f"runs); per-stage device ms, median over calls (median per iteration): "
          + "; ".join(f"{s[3:]} {statistics.median(per_call[s]):.3f} "
                      f"({statistics.median(per_row[s]):.3f})" for s in STAGE_ROWS)
          + f" ({SMI})")
    stage_sums = [sum(per_call[s][i] for s in STAGE_ROWS) for i in range(len(staged["calls"]))]
    pairs = list(zip(stage_sums, staged["summary"]["ba_call_ms"]))
    print(f"timings staged: per call stage sum / ba_call_ms (ms): "
          + ", ".join(f"{a:.1f}/{b:.1f}" for a, b in pairs) + f" ({SMI})")
    over = [(a, b) for a, b in pairs if a > b + STAGE_SUM_SLACK_MS]
    if over:
        failed.append(f"stage sums above their call's ms: {over}")
    sync_ms = [c["header"]["sync_ms"] for c in fused["calls"]]
    print(f"timings fused: {len(fused['calls'])} rows, sync_ms "
          f"{', '.join(f'{x:.3f}' for x in sync_ms)}; fused_iterations "
          f"{[c['header']['fused_iterations'] for c in fused['calls']]}, BA iterations run "
          f"{fused['summary']['ba_iterations']} ({SMI})")
    for tag, run in runs.items():
        top = sorted(run["timers"].items(), key=lambda kv: -kv[1])[:8]
        print(f"timings {tag}: {_frame_medians(run['summary'])}; BA ms per call "
              f"{_ms_median(run['summary']['ba_call_ms'])}; timers (total s) "
              f"{', '.join(f'{k} {v:.3f}' for k, v in top)}; launches {run['launches']} "
              f"({SMI})")

    # Timing changes nothing without the flag: the fused run is the slice.
    # With it, every BA iteration runs (the JAX package's staged loop), which
    # moves poses by more than the slice's hold; the gap is printed and the
    # staged run is held to its own ATE limit.
    dq, dt = float(np.abs(fused["q"] - q_slice).max()), float(np.abs(fused["t"] - t_slice).max())
    gap = max(float(np.abs(staged["q"] - fused["q"]).max()),
              float(np.abs(staged["t"] - fused["t"]).max()))
    ates = {tag: synthetic.ate_rmse(run["poses"], gt) for tag, run in runs.items()}
    print(f"timings: fused run against the slice max |dq| {dq:.3e}, max |dt| {dt:.3e} "
          f"(atol {POSE_ATOL}); staged against fused max gap {gap:.3e}; ATE staged "
          f"{ates['staged']:.3e} m (limit {STAGED_ATE_LIMIT_M}), fused {ates['fused']:.3e} m "
          f"(limit {ATE_LIMIT_M}) ({SMI})")
    if not (dq <= POSE_ATOL and dt <= POSE_ATOL):
        failed.append("the fused run with --save_timings moved off the slice")
    if not (ates["fused"] < ATE_LIMIT_M and ates["staged"] < STAGED_ATE_LIMIT_M):
        failed.append(f"ATE above the limit: {ates}")

    slam = fused["slam"]
    gt_t = np.stack([p.t for p in gt])
    dev = synthetic.ate_rmse_device(slam.traj_t, gt_t)
    if dev.device.type != "cuda":
        failed.append("the device ATE did not stay on the card")
    host = synthetic.ate_rmse([se3.SE3(None, t) for t in slam.traj_t.cpu().numpy()], gt)
    rel = abs(float(dev) - host) / host
    stats = evaluate_ate.associate_and_evaluate(
        os.path.join(workdir, "timings_fused_poses.txt"), os.path.join(data, "groundtruth.txt"))
    print(f"timings: ate_rmse_device on the card {float(dev):.9e} m, host ate_rmse "
          f"{host:.9e} m (rel diff {rel:.2e}, limit {ATE_DEVICE_RTOL}); evaluate_ate "
          f"on the exported poses: {stats['pairs']} pairs, rmse {stats['rmse']:.6e}, "
          f"median {stats['median']:.6e}, max {stats['max']:.6e} m ({SMI})")
    if not rel <= ATE_DEVICE_RTOL:
        failed.append("the device ATE disagrees with the host ATE")
    if stats["pairs"] != FRAMES or not abs(stats["rmse"] - ates["fused"]) <= 1e-6:
        failed.append("evaluate_ate disagrees with the exported poses' ATE")

    # The staged path on the card against the CPU.
    small = os.path.join(workdir, "small")
    flags = SMALL_FLAGS + ["--sync_stage_profiling", "true"]
    small_runs = {}
    for dev_name in ("cuda", "cpu"):
        rows = os.path.join(workdir, f"timings_small_{dev_name}.txt")
        _, _, qs, ts, _, _ = _run_slam(small, workdir, f"timings_small_{dev_name}", dev_name,
                                       flags + ["--save_timings", rows])
        keys = [line.split()[0] for line in open(rows)]
        small_runs[dev_name] = (qs, ts, keys, _parse_rows(rows))
    (qg, tg, kg, _), (qc, tc, kc, _) = small_runs["cuda"], small_runs["cpu"]
    dq, dt = float(np.abs(qg - qc).max()), float(np.abs(tg - tc).max())
    print(f"timings: cpu vs cuda under --sync_stage_profiling, 160x120 BA "
          f"({SMALL_FRAMES} frames): max |dq| {dq:.3e}, max |dt| {dt:.3e} (atol "
          f"{POSE_ATOL}); {len(kg)} rows, keys equal {kg == kc} ({SMI})")
    if not (dq <= POSE_ATOL and dt <= POSE_ATOL and kg == kc):
        failed.append("the staged path disagrees between the card and the CPU")
    if failed:
        raise AssertionError(f"timings checks failed: {failed}")
    return {name: {tag: run["launches"][name] for tag, run in runs.items()}
            for name in (kernels.BILATERAL, kernels.GATHER)}


# Autotune (phase 25): the tuner's calls per tile (one warm-up, then its
# timed calls), as cli.run's --autotune makes them.
AUTOTUNE_CALLS = 1 + tuner.ITERATIONS
# K1's sizes in the tile sweep: VGA (the slice), the undistorted input (the
# input phase), VGA at depth pyramid level 1, the 160x120 sequence (the cpu
# phase) and the ragged 67x160.
TILE_SIZES = ((HEIGHT, WIDTH), INPUT_SIZE, (HEIGHT // 2, WIDTH // 2), (120, 160),
              (67, 160))


def _tile_sweep(tiles, default) -> dict:
    """Device time per call of each tile at each of TILE_SIZES on random
    depth, {(H, W): {tile: ms}}; one line per size."""
    sweep = {}
    for i, size in enumerate(TILE_SIZES):
        depth = _random_depth(10 + i, size, 2.5)
        ms = {tile: device_ms(lambda t=tile: kernels.bilateral_filter_and_cutoff_cuda(
            depth, 2.5, tile=t)) for tile in tiles}
        best = min(ms, key=ms.get)
        blocks = {tile: kernels.bilateral_launch_info(*size, 3, tile) for tile in tiles}
        print(f"K1 tiles at {size[0]}x{size[1]} (device time per call, CUDA graph of 50, "
              f"median of 5; blocks): "
              + ", ".join(f"{kernels.tile_name(t)} {ms[t]:.4f} ms "
                          f"({blocks[t]['grid_x'] * blocks[t]['grid_y']})" for t in tiles)
              + f"; fastest {kernels.tile_name(best)}, "
              f"{100.0 * (1.0 - ms[best] / ms[default]):.1f}% below "
              f"{kernels.tile_name(default)} ({SMI})")
        sweep[size] = ms
    return sweep


def _run_with_store(workdir: str, data: str, tag: str, store: str, flags) -> tuple:
    """A CUDA run against the tuning store `store`: (poses, q, t, summary,
    K1's launches per shape and tile, the tuner's ms per tile, wall
    seconds)."""
    empty_store = tuner._TUNING_PATH
    tuner._TUNING_PATH = store
    try:
        tuner.last_times.clear()
        t0 = time.perf_counter()
        poses, q, t, summary, _ = _run(data, workdir, tag, "cuda", flags)
        wall = time.perf_counter() - t0
        return (poses, q, t, summary, _shapes()[kernels.BILATERAL],
                dict(tuner.last_times), wall)
    finally:
        tuner._TUNING_PATH = empty_store


def _autotuned_run(workdir: str, data: str, tag: str, flags, size, frames, q_ref,
                   t_ref, tiles) -> tuple:
    """A run with --autotune against a store of its own, held to the same
    run without the flag (q_ref, t_ref): (the stored tile, the checks)."""
    store = os.path.join(workdir, f"{tag}_store.json")
    poses, q, t, summary, shapes, tuner_ms, wall = _run_with_store(
        workdir, data, tag, store, flags + ["--autotune"])
    key = tuner.device_key(f"bilateral_{size[0]}x{size[1]}", "cuda")
    with open(store) as f:
        stored = json.load(f)
    winner = next((tl for tl in tiles if kernels.tile_name(tl) == stored.get(key)), None)
    expected = {(*size, tl): AUTOTUNE_CALLS + (frames if tl == winner else 0)
                for tl in tiles}
    dq, dt = float(np.abs(q - q_ref).max()), float(np.abs(t - t_ref).max())
    later = [ms for _, ms in summary["frame_ms"][1:]]
    print(f"autotune: {tag} ({frames} frames at {size[1]}x{size[0]}) with --autotune on "
          f"cuda in {wall:.1f} s wall; store {stored}; tuner ms per call (CUDA events "
          f"over {tuner.ITERATIONS} calls) "
          f"{', '.join(f'{n} {ms:.4f}' for n, ms in tuner_ms.items())}; poses against "
          f"the unflagged run: max |dq| {dq:.3e}, max |dt| {dt:.3e} (atol {POSE_ATOL}); "
          f"per-frame median {statistics.median(later):.2f} ms after the first; K1 "
          f"launches per shape and tile {shapes} ({SMI})")
    checks = {
        f"{tag}: the store holds {key}": winner is not None and list(stored) == [key],
        f"{tag}: K1's frames took the stored tile, the tuning 1 + {tuner.ITERATIONS} "
        f"calls per tile": shapes == expected,
        f"{tag}: {frames} poses": len(poses) == frames,
        f"{tag}: poses equal to the unflagged run's": dq <= POSE_ATOL and dt <= POSE_ATOL,
        f"{tag}: the tuner timed every tile":
            set(tuner_ms) == set(map(kernels.tile_name, tiles)),
    }
    return winner, checks


def phase_autotune(workdir: str, data: str, input_data: str, q_odo, t_odo, small,
                   q_small, t_small) -> None:
    """K1's tiles at VGA against the default tile and the plain version,
    their times at each of TILE_SIZES, then the odometry run and phase 7's
    160x120 run (`small`, poses q_small, t_small) with --autotune, each
    against a store of its own, and the odometry run against a store that
    holds the tile the VGA tuning did not keep."""
    tiles = kernels.bilateral_tiles()
    default = _default_tile()
    if tiles != [(8, 2), (8, 1)]:
        raise AssertionError(f"K1's tile table {tiles}: expected [(8, 2), (8, 1)], the "
                             f"default first")
    inputs = _k1_inputs(_undistorted_frame(input_data))
    # Per input: the plain version's output and the default tile's.
    refs = {what: (bilateral_filter_and_cutoff(d, m),
                   kernels.bilateral_filter_and_cutoff_cuda(d, m, tile=default))
            for what, m, d in inputs}
    vga = inputs[0][2]
    graph_ms = {}
    for tile in tiles:
        worst_err, bitwise = 0.0, True
        for what, max_depth, depth in inputs:
            out = kernels.bilateral_filter_and_cutoff_cuda(depth, max_depth, tile=tile)
            ref, base = refs[what]
            torch.cuda.synchronize()
            worst_err = max(worst_err, float((out - ref).abs().max()))
            bitwise = bitwise and torch.equal(out, base)
        graph_ms[tile] = device_ms(
            lambda: kernels.bilateral_filter_and_cutoff_cuda(vga, 2.5, tile=tile))
        print(f"K1 tile {kernels.tile_name(tile)}{' (default)' if tile == default else ''}"
              f": device time per call at {HEIGHT}x{WIDTH} (CUDA graph of 50, median of "
              f"5) {graph_ms[tile]:.4f} ms; on the {len(inputs)} K1 inputs bit-equal to "
              f"the default tile: {bitwise}, max_abs_err against plain {worst_err:.3e} "
              f"(atol {KERNEL_ATOL}); {_k1_launch(HEIGHT, WIDTH, 3, tile)} ({SMI})")
        if not (bitwise and worst_err <= KERNEL_ATOL):
            raise AssertionError(f"K1 tile {tile} disagrees with the default tile or the "
                                 f"plain version")
    _tile_sweep(tiles, default)

    # The odometry run and phase 7's 160x120 BA run with --autotune, each
    # against a store of its own.
    winner, checks = _autotuned_run(workdir, data, "odometry_autotune", ODOMETRY_FLAGS,
                                    (HEIGHT, WIDTH), ODOMETRY_FRAMES, q_odo, t_odo, tiles)
    print(f"autotune: the tuned VGA tile {winner} "
          f"{graph_ms.get(winner, float('nan')):.4f} ms against the default "
          f"{kernels.tile_name(default)} {graph_ms[default]:.4f} ms (CUDA graph of 50, "
          f"median of 5; {SMI})")
    _, small_checks = _autotuned_run(workdir, small, "small_autotune", SMALL_FLAGS,
                                     (120, 160), SMALL_FRAMES, q_small, t_small, tiles)
    checks.update(small_checks)

    # The odometry run (no --autotune) against a store that holds another
    # tile than the VGA winner: every frame's launch must take it.
    key = tuner.device_key(f"bilateral_{HEIGHT}x{WIDTH}", "cuda")
    forced = next(tl for tl in tiles if tl != winner)
    forced_store = os.path.join(workdir, "forced_store.json")
    with open(forced_store, "w") as f:
        json.dump({key: kernels.tile_name(forced)}, f)
    poses_f, q_f, t_f, _, shapes_f, _, _ = _run_with_store(
        workdir, data, "forced_tile", forced_store, ODOMETRY_FLAGS)
    dq_f, dt_f = float(np.abs(q_f - q_odo).max()), float(np.abs(t_f - t_odo).max())
    print(f"autotune: odometry against a store holding {kernels.tile_name(forced)}: K1 "
          f"launches per shape and tile {shapes_f}; poses against the odometry phase: "
          f"max |dq| {dq_f:.3e}, max |dt| {dt_f:.3e} (atol {POSE_ATOL})")
    checks.update({
        f"K1's frames took {kernels.tile_name(forced)} from a store that holds it":
            shapes_f == {(HEIGHT, WIDTH, forced): ODOMETRY_FRAMES},
        f"{ODOMETRY_FRAMES} poses with {kernels.tile_name(forced)}":
            len(poses_f) == ODOMETRY_FRAMES,
        f"poses with {kernels.tile_name(forced)} equal to the odometry phase's":
            dq_f <= POSE_ATOL and dt_f <= POSE_ATOL,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"autotune checks failed: {failed}")


_KERNEL_ROWS = (
    (kernels.BILATERAL, "badslam_torch/csrc/bilateral.cu",
     "badslam_tpu/ops/pallas_kernels.py:105"),
    (kernels.GATHER, "badslam_torch/csrc/gather.cu",
     "tools/probe_pallas_gather.py:82"),
    (kernels.GATHER_ONEHOT, "badslam_torch/csrc/gather.cu",
     "tools/probe_pallas_gather.py:120"),
    (kernels.POSE_COEFFS, "badslam_torch/csrc/pose_coeffs.cu",
     "none (the plain chain of badslam_torch/ba/pose_opt.py surfel_pose_coeffs_plain)"),
    (kernels.TRACK_COEFFS, "badslam_torch/csrc/track_coeffs.cu",
     "none (the plain chain of badslam_torch/tracking/pairwise.py "
     "accumulate_pose_coeffs_plain)"),
    (kernels.GEOMETRY_NORMALS, "badslam_torch/csrc/geometry_coeffs.cu",
     "none (the plain chain of badslam_torch/ba/geometry_opt.py "
     "_act_normals_chunk_plain)"),
    (kernels.GEOMETRY_POSITION, "badslam_torch/csrc/geometry_coeffs.cu",
     "none (the plain chain of badslam_torch/ba/geometry_opt.py _pos_chunk_plain)"),
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
    with tempfile.TemporaryDirectory() as workdir:
        # An empty tuning store: one left by an earlier --autotune run must
        # not pick K1's tile (phase autotune swaps in a store of its own).
        tuner._TUNING_PATH = os.path.join(workdir, "tuning.json")
        tuner._cache.clear()
        input_data, gt_kept = _phase("input data", write_input_sequence, workdir)
        measured = _phase("kernels", phase_kernels, input_data)
        probe_launches = _phase("probe", phase_probe)
        # From here on a second process shares the card (the kernels above
        # are timed alone).
        off_job = start_loop_off(workdir)
        try:
            data, slice_launches, q_slice, t_slice, slice_summary = _phase(
                "slice", phase_slice, workdir)
            _phase("steady", phase_steady, data)
            _phase("ba_graph", phase_ba_graph, data)
            if profile_dir:
                _phase("profile", phase_profile, data, profile_dir)
            q_odo, t_odo = _phase("odometry", phase_odometry, workdir, data)
            small, q_small, t_small = _phase("cpu", phase_cpu, workdir, data, q_odo, t_odo)
            _phase("input", phase_input, workdir, input_data, gt_kept)
            _phase("pyramid", phase_pyramid, workdir)
            _phase("resume", phase_resume, workdir, data, q_slice, t_slice)
            _phase("cpu_input", phase_cpu_input, workdir)
            calib_data, calib_gt, calib_cam = _phase("calibration", phase_calibration, workdir)
            _phase("pcg", phase_pcg, workdir, calib_data, calib_gt, calib_cam)
            _phase("cpu_calibration", phase_cpu_calibration, workdir)
            loop_launches = _phase("loop", phase_loop, workdir, off_job)
            _phase("cpu_loop", phase_cpu_loop, workdir)
            _phase("closure_graph", phase_closure_graph, workdir)
            live_slam, q_live, t_live, live_launches = _phase("live", phase_live, workdir, data)
            _phase("tcp", phase_tcp, workdir, data, q_live, t_live)
            _phase("viewer_controls", phase_viewer_controls, workdir, live_slam)
            _phase("cpu_live", phase_cpu_live, workdir)
            _phase("sdk", phase_sdk)
            multi_launches, multi_slams = _phase("multi", phase_multi, workdir, data,
                                                 q_slice, t_slice, slice_summary)
            _phase("mesh_graph", phase_mesh_graph, multi_slams)
            del multi_slams
            _phase("cpu_multi", phase_cpu_multi, workdir)
            timings_launches = _phase("timings", phase_timings, workdir, data, q_slice,
                                      t_slice)
            _phase("autotune", phase_autotune, workdir, data, input_data, q_odo, t_odo,
                   small, q_small, t_small)
        finally:
            if off_job.poll() is None:
                off_job.kill()
                off_job.wait()
    print(f"launches on the slice's path (loop detection off): {slice_launches}")
    print(f"launches on the live path (directory stream with the viewer): {live_launches}")
    print(f"launches on the multi-device path (2 shards, integrated / streamed): "
          f"{multi_launches}")
    print(f"launches on the timing path (the slice with --save_timings, staged / fused): "
          f"{timings_launches}")
    rows = []
    for kname, source, replaces in _KERNEL_ROWS:
        # K1, K2, H1, H2 and H3 are on the SLAM path: their launches are
        # those of the default main path's run (the loop phase, loop
        # closure on). K3 is only on the probe path: its launches are the
        # probe's.
        launches = (probe_launches if kname == kernels.GATHER_ONEHOT
                    else loop_launches)[kname]
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
