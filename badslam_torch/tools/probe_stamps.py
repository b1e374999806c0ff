"""Probe the device stamps on a CUDA card: what they cost, the clocks they
are mapped onto, and the host synchronizations of a run.

    python -m badslam_torch.tools.probe_stamps [--parts cost,clock,syncs] [--out FILE]

Prints one JSON object (and writes it to ``--out``):

* ``cost``: a synthetic 640x480 sequence with keyframe BA runs on the card.
  The graphs of its last steady frame and of its last BA call are captured
  once more without the stamps (``Timing.stamping = False``) over the same
  static inputs. Then the stamped and the plain graph of each kind are
  replayed in turn, each from the state held before that frame or call and
  between two CUDA events that follow a sleep of the card (so the launch
  is left out). Reports the medians of both, the device
  iterations of each replay (the same work) and whether the two leave the
  same state; and the run's own steady replays on the card
  (``device_timeline``) by kind: keyframe frames, the first frame after a
  BA call, the others.
* ``clock``: which host clock torch.profiler's events are on (a range's
  kineto start against the monotonic, realtime and perf_counter clocks read
  around it); the globaltimer's smallest step seen by one thread reading it
  back to back (a kernel built here with nvcc); the spread of 20 clock
  pairs; the drift of the mapping over the calibrations taken so far (a
  whole ``cost`` part, when it ran first); how far CUPTI's start of an
  eager stamp kernel, and of a steady replay's first stamp, lies from its
  own reading mapped onto the profiler's clock.
* ``syncs``: the stream and device synchronizations and the device copies
  per ``BadSlam.run`` after the captures (160x120, BA in every run), counted
  in torch.profiler's CPU events as ``cli.py``'s ``--profile`` summary
  counts them. This part also runs on a checkout without the stamps: run
  this file by its path with that checkout first on ``PYTHONPATH``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")
# About 50 ms of the card's clock cycles.
SLEEP_CYCLES = 100_000_000

# One thread reads the globaltimer `reads` times back to back: the smallest
# nonzero step between two reads, the steps seen and the span.
_STEP_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void steps(long long* out, int reads) {
  long long first, last, t, step = 0, seen = 0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(first));
  last = first;
  for (int i = 0; i < reads; ++i) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t != last) {
      if (step == 0 || t - last < step) step = t - last;
      seen += 1;
      last = t;
    }
  }
  out[0] = step; out[1] = seen; out[2] = last - first;
}
extern "C" int globaltimer_steps(void* stream, void* out, int reads) {
  steps<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(out), reads);
  return cudaGetLastError();
}
"""


def _sequence(workdir: str, width: int, height: int, frames: int) -> str:
    from badslam_torch import synthetic

    path = os.path.join(workdir, f"seq_{width}x{height}_{frames}")
    synthetic.write_tum_dataset(
        path, synthetic.default_camera(width, height),
        synthetic.random_plane_scene(np.random.default_rng(5), 6),
        synthetic.smooth_trajectory(frames, scale=0.003))
    return path


def _slam(path: str, device: torch.device, **config):
    from badslam_torch.config import BadSlamConfig
    from badslam_torch.frontend import BadSlam
    from badslam_torch.io.dataset import load_tum_dataset

    config = BadSlamConfig(max_surfel_count=1 << 20, enable_loop_detection=False,
                           fps_restriction=0, **config)
    return BadSlam(config, load_tum_dataset(path), device)


def _tensors(obj) -> list:
    """The tensors among an object's fields (a tuple's items, else its
    attributes), and one level down in its tuples and lists."""
    items = list(obj) if isinstance(obj, tuple) else list(vars(obj).values())
    out = []
    for v in items:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            out += [x for x in v if isinstance(x, torch.Tensor)]
    return [t for t in out if t.is_cuda]


class _Held:
    """Device tensors and a copy of their values, to put back."""

    def __init__(self, tensors: list):
        self.tensors = tensors
        self.values = [t.clone() for t in tensors]

    def restore(self) -> None:
        for t, v in zip(self.tensors, self.values):
            t.copy_(v)

    def now(self) -> list:
        return [t.clone() for t in self.tensors]


def _changed(graphs: dict, before: dict):
    """The key of the graph whose replays went up since `before`."""
    return next(k for k, c in graphs.items() if c.record["replays"] != before.get(k, 0))


def _alternate(graphs: dict, held: _Held, work, rounds: int) -> dict:
    """Replay each of `graphs` ({name: CUDAGraph}) from `held`'s state,
    `rounds` times in turn (the order reversed every other round), each
    between two CUDA events. {name: (ms per replay, work per replay)} and
    whether every graph left the same state after its first replay."""
    out = {name: ([], []) for name in graphs}
    after = {}
    names = list(graphs)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            held.restore()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            # The card sleeps while the host launches the graph, so that the
            # events time the replay and not its launch.
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            graphs[name].replay()
            end.record()
            end.synchronize()
            out[name][0].append(start.elapsed_time(end))
            out[name][1].append(work(name))
            if name not in after:
                after[name] = held.now()
    first = after[names[0]]
    same = all(all(torch.equal(a, b) for a, b in zip(first, after[n])) for n in names[1:])
    result = {name: {"median_ms": statistics.median(ms), "replays": len(ms),
                     "work": sorted(set(map(str, work_)))}
              for name, (ms, work_) in out.items()}
    result["same_state"] = same
    return result


def part_cost(workdir: str, device: torch.device, frames: int, rounds: int) -> dict:
    from badslam_torch import steady as steady_mod
    from badslam_torch.ba import graph as ba_graph_mod
    from badslam_torch.utils.timing import Timing

    last_steady, last_ba = {}, {}
    steady_run, ba_run = steady_mod.SteadyFrameGraph.run, ba_graph_mod.BAGraph.run

    def held_steady(self, key, cam, cams, undistort_map, *, test_two, frame_index, **state):
        self._bind(**state)
        self.idx.fill_(frame_index)
        held = _Held(list(self._static.values()) + [self.idx])
        before = {k: c.record["replays"] for k, c in self._graphs.items()}
        out = steady_run(self, key, cam, cams, undistort_map, test_two=test_two,
                         frame_index=frame_index, **state)
        last_steady.update(graph=self, gkey=_changed(self._graphs, before), key=key, cam=cam,
                           cams=cams, undistort_map=undistort_map, test_two=test_two,
                           held=held, frame=frame_index)
        return out

    def held_ba(self, ba, sel, bucket, max_iterations, call):
        # Per graph, the call that ran the most iterations (a device read).
        held = _Held(_tensors(ba.surfels) + _tensors(ba.keyframes) + _tensors(ba))
        # The graph's scalar inputs, as run() is about to fill them.
        for t, v in ((self.limit, max_iterations), (self.ba_iter, ba.ba_iteration_count),
                     (self.min_obs, ba.min_observation_count())):
            held.tensors.append(t)
            held.values.append(torch.full_like(t, v))
        before = {k: c.record["replays"] for k, c in self._graphs.items()}
        out = ba_run(self, ba, sel, bucket, max_iterations, call)
        key = _changed(self._graphs, before)
        if int(out) >= last_ba.get(key, {}).get("iterations", 0):
            last_ba[key] = dict(graph=self, key=key, ba=ba, sel=sel, bucket=bucket, call=call,
                                held=held, iterations=int(out))
        return out

    steady_mod.SteadyFrameGraph.run = held_steady
    ba_graph_mod.BAGraph.run = held_ba
    try:
        slam = _slam(_sequence(workdir, 640, 480, frames), device)
        t0 = time.perf_counter()
        slam.run()
        torch.cuda.synchronize(device)
        run_s = time.perf_counter() - t0
    finally:
        steady_mod.SteadyFrameGraph.run = steady_run
        ba_graph_mod.BAGraph.run = ba_run

    # The run's steady replays on the card, by kind (before the probe's own
    # replays enter the ring).
    kinds = {"keyframe": [], "after_ba_call": [], "other": []}
    keyframes, previous = set(slam.keyframe_frames), None
    for e in slam.device_timeline():
        if e["graph"] == "steady frame":
            kind = ("keyframe" if e["frame"] in keyframes else
                    "after_ba_call" if previous == "BA call" else "other")
            kinds[kind].append((e["end_ns"] - e["start_ns"]) * 1e-6)
        previous = e["graph"]
    replays = {k: {"median_ms": statistics.median(v), "mean_ms": statistics.mean(v),
                   "replays": len(v)} for k, v in kinds.items() if v}

    s = last_steady
    g = s["graph"]
    stamped = g._graphs[s["gkey"]]
    Timing.stamping = False
    try:
        plain = g._capture(s["key"], s["cam"], s["cams"], s["undistort_map"], s["test_two"],
                           "probe")
    finally:
        Timing.stamping = True
    steady_graphs = {"stamped": stamped, "plain": plain}
    steady = _alternate(
        {n: c.graph for n, c in steady_graphs.items()}, s["held"],
        lambda n: [int(torch.as_tensor(i).sum()) for i in steady_graphs[n].outputs.iterations],
        rounds)
    steady.update(frame=s["frame"], kernel_nodes={n: c.record["kernel_nodes"]
                                                  for n, c in steady_graphs.items()})

    b = max((c for k, c in last_ba.items() if k in c["graph"]._graphs),
            key=lambda c: c["iterations"])
    g = b["graph"]
    stamped = g._graphs[b["key"]]
    Timing.stamping = False
    try:
        sel_t = None if b["sel"] is None else g._slots(b["sel"])
        plain = g._capture(b["ba"], sel_t, b["bucket"], b["call"], b["key"], "probe")
    finally:
        Timing.stamping = True
    ba_graphs = {"stamped": stamped, "plain": plain}
    ba = _alternate({n: c.graph for n, c in ba_graphs.items()}, b["held"],
                    lambda n: int(ba_graphs[n].iterations), max(4, rounds // 2))
    ba.update(keyframe_bucket=b["key"].keyframe_bucket, surfel_bucket=b["bucket"],
              kernel_nodes={n: c.record["kernel_nodes"] for n, c in ba_graphs.items()})
    return {"frames": frames, "run_s": run_s, "run_steady_replays": replays, "steady": steady,
            "ba": ba}


def _globaltimer_steps(workdir: str, device: torch.device, reads: int = 1 << 16) -> dict:
    from badslam_torch.ops import kernels

    src = os.path.join(workdir, "globaltimer_steps.cu")
    lib_path = os.path.join(workdir, "libglobaltimer_steps.so")
    with open(src, "w") as f:
        f.write(_STEP_SOURCE)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.globaltimer_steps.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    out = torch.zeros(3, dtype=torch.int64, device=device)
    err = lib.globaltimer_steps(torch.cuda.current_stream(device).cuda_stream,
                                out.data_ptr(), reads)
    if err:
        raise RuntimeError(f"the globaltimer probe failed: CUDA error {err}")
    step, seen, span = out.tolist()
    return {"smallest_step_ns": step, "steps_seen": seen, "span_ns": span, "reads": reads}


def _profiler_clock() -> dict:
    """Per host clock, (kineto start - the clock read before the range, the
    clock read after - kineto start) in ns: both small and positive for the
    profiler's own clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    clocks = {"monotonic": time.monotonic_ns, "realtime": time.time_ns,
              "perf_counter": time.perf_counter_ns}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        before = {k: f() for k, f in clocks.items()}
        with record_function("probe/clock"):
            pass
        after = {k: f() for k, f in clocks.items()}
    start = next(e.start_ns() for e in prof.profiler.kineto_results.events()
                 if e.name() == "probe/clock")
    return {k: [start - before[k], after[k] - start] for k in clocks}


def _eager_stamps(device: torch.device, n: int = 20) -> dict:
    """CUPTI's start of n eager end-stamp kernels against their own ring
    entries mapped onto the profiler's clock (ns), with the clock read just
    before and after the profiled stamps."""
    from torch.profiler import ProfilerActivity, profile

    from badslam_torch.ops import conditional
    from badslam_torch.utils.timing import Timing

    table = Timing.stamp_table(device)
    r = table.row("probe stamp")
    Timing.fold_tables()
    torch.cuda.synchronize(device)
    table.calibrate(8)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            conditional.stamp(table.rows[r], conditional.STAMP_BEGIN, table.ctl, table.ring)
            conditional.stamp(table.rows[r], conditional.STAMP_END_RING, table.ctl, table.ring,
                              None, r)
            torch.cuda.synchronize(device)
    Timing.fold_tables()
    table.calibrate(8)
    entries = [e for e in table.timeline() if e["graph"] == "probe stamp"][-n:]
    ends = sorted(ev.start_ns() for ev in prof.profiler.kineto_results.events()
                  if ev.device_type().name == "CUDA" and "stamp_replay_end" in ev.name())
    offsets = [k - e["end_ns"] for k, e in zip(ends, entries)]
    return {"compared": len(offsets), "cupti_minus_mapped_ns": [min(offsets), max(offsets)]
            if offsets else None}


def _replay_alignment(workdir: str, device: torch.device) -> dict:
    """Under torch.profiler (CPU and CUDA), CUPTI's start of each steady
    replay's first and last stamp kernels (where recorded) against the
    replay's start and end in ``device_timeline`` (ns; the replays matched
    to the graph launches in order, as in the test
    ``test_device_timeline_lines_up_with_the_profiler``, at 160x120)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from badslam_torch.utils.timing import PROFILER_CLOCK

    slam = _slam(_sequence(workdir, 160, 120, 13), device, num_scales=4, keyframe_interval=6,
                 max_num_ba_iterations_per_keyframe=0)
    slam.run(0, 7)
    torch.cuda.synchronize(device)
    t0 = time.clock_gettime_ns(PROFILER_CLOCK)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        slam.run(7, 13)
        torch.cuda.synchronize(device)
    replays = [r for r in slam.device_timeline() if r["start_ns"] >= t0]
    events = list(prof.profiler.kineto_results.events())
    recorded = defaultdict(list)
    for ev in events:
        if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation():
            recorded[ev.correlation_id()].append((ev.start_ns(), ev.name()))
    launches = sorted((ev.start_ns(), ev.correlation_id()) for ev in events
                      if ev.device_type() == DeviceType.CPU
                      and ev.name().startswith("cudaGraphLaunch"))
    gaps = {}
    for r, (_, correlation) in zip(replays, launches):
        if r["graph"] != "steady frame":
            continue
        for start, name in recorded.get(correlation, []):
            if "stamp_replay_begin" in name:
                gaps[f'{r["frame"]} begin'] = start - r["start_ns"]
            elif "stamp_replay_end" in name:
                gaps[f'{r["frame"]} end'] = start - r["end_ns"]
    return {"replays": len(replays), "graph_launches": len(launches),
            "cupti_minus_mapped_ns": gaps}


def part_clock(workdir: str, device: torch.device) -> dict:
    from badslam_torch.ops import conditional
    from badslam_torch.utils.timing import PROFILER_CLOCK, Timing

    table = Timing.stamp_table(device)
    torch.cuda.synchronize(device)
    pairs = [conditional.clock_pair(device, PROFILER_CLOCK) for _ in range(20)]
    offsets = [h - d for h, d, _ in pairs]
    (d0, o0), (d1, o1) = table.calibrations[0], table.calibrations[-1]
    return {"profiler_clock": _profiler_clock(),
            "globaltimer": _globaltimer_steps(workdir, device),
            "clock_pair_spread_ns": max(offsets) - min(offsets),
            "clock_pair_round_trip_ns": sorted(r for _, _, r in pairs)[::6],
            "eager_stamps": _eager_stamps(device),
            "calibrations": len(table.calibrations),
            "drift_ns": o1 - o0, "drift_window_s": (d1 - d0) * 1e-9,
            "drift_ppm": 1e6 * (o1 - o0) / (d1 - d0) if d1 > d0 else None,
            "replays": _replay_alignment(workdir, device)}


def part_syncs(workdir: str, device: torch.device, runs: int = 4) -> dict:
    from torch.profiler import ProfilerActivity, profile

    slam = _slam(_sequence(workdir, 160, 120, 7 + 6 * runs), device, num_scales=4,
                 keyframe_interval=6, max_num_ba_iterations_per_keyframe=4)
    slam.run(0, 7)  # the captures
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(runs):
            slam.run(7 + 6 * k, 13 + 6 * k)
    counts = {e.key: e.count for e in prof.key_averages() if e.key in SYNC_EVENTS}
    return {"runs": runs, "frames_per_run": 6, "counts": counts,
            "per_run": {k: v / runs for k, v in counts.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parts", default="cost,clock,syncs",
                   help="comma-separated: cost, clock, syncs (in this order)")
    p.add_argument("--frames", type=int, default=42, help="frames of the cost run")
    p.add_argument("--rounds", type=int, default=40, help="steady replays of each graph")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_stamps needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    parts = [x.strip() for x in args.parts.split(",") if x.strip()]
    result = {"device": torch.cuda.get_device_name(device)}
    with tempfile.TemporaryDirectory() as workdir:
        for part in ("cost", "clock", "syncs"):
            if part not in parts:
                continue
            t0 = time.perf_counter()
            if part == "cost":
                result[part] = part_cost(workdir, device, args.frames, args.rounds)
            elif part == "clock":
                result[part] = part_clock(workdir, device)
            else:
                result[part] = part_syncs(workdir, device)
            result[part]["seconds"] = time.perf_counter() - t0
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
