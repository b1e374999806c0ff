"""The rest of a run, driven on the CPU at the tiny size without the look
for a card, comes out correct; with each fault a one-chip cell can have
planted underneath (faults.py), correct comes out false. The turn mix
makes the camera see surfaces the first keyframe never saw, so a BA that
leaves its state unchanged leaves them unexplained."""

import time

import pytest

from slam_bench import bench, faults
from slam_bench.tests.helpers import tiny_cell


def _run(fault=None, controls=()):
    cell = tiny_cell("turn")
    if fault is None:
        return bench.run_cell(cell, 5, 1.0, False, "cpu", time.perf_counter(),
                              log=lambda s: None, controls=controls)
    with faults.planted(fault):
        return bench.run_cell(cell, 5, 1.0, False, "cpu", time.perf_counter(),
                              log=lambda s: None)


def test_sound_run_is_correct_and_the_control_is_not():
    r = _run(controls=("bf16",))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"fps", "frame_ms_p50", "frame_ms_p95", "setup_s"}
    assert r["attempted"] == 30  # 1 s of the recording: 6 intervals of 5 frames
    ctrl = r["controls"]["bf16"]["pose_gap_p50_um"]
    assert ctrl["value"] > ctrl["limit"], ctrl


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_fault_is_caught(fault):
    r = _run(fault)
    assert not r["correct"], r["checks"]
