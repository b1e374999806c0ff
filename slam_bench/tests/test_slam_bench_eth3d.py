"""The eth3d_739x458 configuration and its cell: found by name as the
harness finds every cell, its one cut of scale, and the reader of the
steady frame's preprocessing stamp."""

import os

import pytest

from slam_bench import bench
from slam_bench.metrics import steady_preprocess_ms
from slam_bench.tests.helpers import ROOT, load

CELL = "eth3d_739x458.corridor_walk"


def test_steady_preprocess_ms_reads_the_stamp_per_replay():
    timers = {"steady frame [graph]": (250, 8.5),
              "steady frame: preprocess [graph]": (250, 0.75)}
    assert steady_preprocess_ms.read({"timing_s": timers}) == pytest.approx(3.0)
    # A program without the stamp (the parent of the stamp, a CPU run).
    assert steady_preprocess_ms.read({"timing_s": {"steady frame [graph]": (250, 8.5)}}) is None
    assert steady_preprocess_ms.read({"timing_s": {}}) is None


def test_the_cell_is_found_by_name(monkeypatch):
    monkeypatch.chdir(ROOT)
    cell = bench.load_cell(CELL)
    w = cell["workload"]
    assert (w["config"], w["traffic"], w["chips"]) == ("eth3d_739x458", "corridor_walk", 1)
    c = cell["config"]["camera"]
    assert (c["width"], c["height"], c["fx"], c["fy"]) == (739, 458, 726.3, 726.3)
    assert cell["mix"] == bench.scene.load_mix("corridor_walk")
    # The tracker loses its pose in two to four of this camera's 29 window
    # intervals, so the pose gap samples 16 of them (the tum cells 6) and
    # its median stays among the tracked frames; the keyframe drift is
    # logged and not compared (PERF.md section 2).
    limits = cell["limits"]
    assert limits["intervals_checked"] == 16
    assert min(limits[n] for n in ("pose_gap_p50_um", "map_miss_pct", "surfel_noise_mm")) > 0
    assert "kf_drift_mm" not in limits
    assert [m["name"] for m in cell["end_to_end"]] == ["fps", "frame_ms_p50", "setup_s"]
    assert [m["name"] for m in cell["per_layer"]] == ["steady_preprocess_ms"]
    # The same settings as the tum_vga cells: only the camera differs.
    tum = load(os.path.join(ROOT, "slam_bench", "configs", "tum_vga.json"))
    assert cell["config"]["settings"] == tum["settings"]


def test_the_configuration_cuts_the_surfel_capacity_alone():
    manifest = load(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next(c for c in manifest["configs"] if c["name"] == "eth3d_739x458")
    assert entry["reduced"] == ["max_surfel_count"]
    cfg = load(os.path.join(ROOT, entry["file"]))
    assert set(cfg["changed_from_defaults"]) == {"max_surfel_count"}
    assert cfg["settings"]["max_surfel_count"] == 4194304
