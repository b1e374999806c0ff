"""A bounded slice of the window under ``torch.profiler``, reduced to what
the per-layer readers and the result's breakdown need.

The slice is the 2 keyframe intervals after the warm-up. A whole window
holds millions of kernel nodes (some 13,700 per steady frame), too many
to trace. ``Slice`` starts the profiler (CPU and CUDA activities) after a
synchronize, marks the slice with the record_function range
``slam_bench/slice``, and stops after a synchronize. ``reduce`` then reads
the device's operations (kernels, copies, sets) out of the profile. The
trace does not hold all the device's work: in a slice of 20 frames it
holds some 240,000 operations over 1.2-1.8 s of device activity, and about
half of K2's launches, against 8-10 s between the slice's first and last
pose on the device's clock. A traced run logs the launches the trace holds
beside the program's exact counts; its busy time is a floor, and no idle
share is read from it.

* the slice's length on the device's clock (its first operation's start
  to its last one's end) and the seconds in which some operation ran on
  the device (the union of their intervals);
* the device operations that took most time, by name;
* the idle gaps between device operations, each named by the innermost
  host record_function range open at its midpoint (the program's own:
  ``steady_frame``, ``ba``, ``ba_drain``, ``loop_drain_wait``, ...);
* K1's and K2's launches: each kernel's duration and K2's grid (from the
  exported trace, written under TMPDIR and removed), for the roofline
  readers.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from slam_bench import roofline

SLICE = "slam_bench/slice"
_NAMED_GAP_NS = 10_000


class Slice:
    """Profile the work of a with-block (on a CUDA device)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof: Optional[profile] = None

    def __enter__(self):
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self._range = record_function(SLICE)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        torch.cuda.synchronize(self.device)
        self.prof.stop()
        return False


def _short(name: str) -> str:
    """A kernel's name without its trailing argument list, at most 120
    characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]


def reduce(prof: profile) -> dict:
    """The slice's device activity (seconds on the profiler's clock)."""
    events = prof.profiler.kineto_results.events()
    device, annotations = [], []
    for ev in events:
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            device.append((start, start + dur, ev.name(), ev))
        elif ev.is_user_annotation() and ev.name() != SLICE:
            annotations.append((start, start + dur, ev.name()))
    # The device-side copies of host ranges span kernels: not operations.
    ranges = {a[2] for a in annotations} | {SLICE}
    device_ops = [op for op in device if op[2] not in ranges and not op[3].is_user_annotation()]
    if not device_ops:
        return {"found": False}
    # The traced window: from the device's first operation to its last (the
    # host range's own timestamps are not on the device's clock).
    device_ops.sort(key=lambda op: op[0])
    lo, hi = device_ops[0][0], max(op[1] for op in device_ops)

    # The union of the device's busy intervals, and the gaps between them.
    busy_ns = 0
    gaps = []
    cur_lo, cur_hi = max(lo, device_ops[0][0]), min(hi, device_ops[0][1])
    if cur_lo > lo:
        gaps.append((lo, cur_lo))
    for s, e, _, _ in device_ops[1:]:
        s, e = max(lo, s), min(hi, e)
        if s > cur_hi:
            busy_ns += cur_hi - cur_lo
            gaps.append((cur_hi, s))
            cur_lo, cur_hi = s, e
        else:
            cur_hi = max(cur_hi, e)
    busy_ns += cur_hi - cur_lo
    if cur_hi < hi:
        gaps.append((cur_hi, hi))

    by_name = defaultdict(float)
    k1 = []
    for s, e, name, _ in device_ops:
        by_name[_short(name)] += (e - s) * 1e-9
        if roofline.K1_NAME in name:
            k1.append((e - s) * 1e-9)

    # Each gap of 10 us or more is named by the shortest host range open at
    # its midpoint; the shorter ones (between the kernels of a graph) are
    # summed under one name.
    gap_names = defaultdict(float)
    a_lo = np.array([a[0] for a in annotations], np.int64)
    a_hi = np.array([a[1] for a in annotations], np.int64)
    order = np.argsort(a_hi - a_lo, kind="stable")
    a_lo, a_hi = a_lo[order], a_hi[order]
    names = [annotations[i][2] for i in order]
    for g_lo, g_hi in gaps:
        if g_hi - g_lo < _NAMED_GAP_NS:
            gap_names["(gaps under 10 us)"] += (g_hi - g_lo) * 1e-9
            continue
        mid = (g_lo + g_hi) // 2
        inside = np.nonzero((a_lo <= mid) & (a_hi >= mid))[0]
        gap_names[names[inside[0]] if len(inside) else "(no host range)"] += \
            (g_hi - g_lo) * 1e-9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"found": True, "window_s": (hi - lo) * 1e-9, "busy_s": busy_ns * 1e-9,
            "device_ops": top(by_name), "idle_gaps": top(gap_names),
            "k1": k1, "k2": _k2_launches(prof), "device_op_count": len(device_ops)}


def _k2_launches(prof: profile) -> list:
    """(seconds, index bytes, blocks) of each K2 launch of the profile: the
    grid is only in the exported trace's kernel arguments. The file goes
    under TMPDIR and is removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    out = []
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        size = roofline.k2_index_bytes(ev.get("name", ""))
        grid = ev.get("args", {}).get("grid")
        if size is not None and grid:
            out.append((1e-6 * float(ev["dur"]), size, int(grid[0])))
    return out
