"""BENCHMARK.json against the contract's shape, and every file a cell needs
found by name."""

import importlib
import json
import os
import re

import pytest

from slam_bench.tests.helpers import ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = load(os.path.join(ROOT, "BENCHMARK.json"))
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["slam_bench"]
    assert len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "fps", "frame_ms_p50", "frame_ms_p95", "setup_s"]
    assert [w["name"] for w in BENCH["workloads"]] == [
        "tum_vga.corridor_walk", "tum_vga.desk_hover"]


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    texts = [entry[k] for k in ("why", "layer") if k in entry]
    if "file" in entry:  # a configuration's source
        texts.append(entry["source"])
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_unique_names_and_bounds():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in BENCH["workloads"]]
    reported = {e["name"]: set(e.get("workloads", cells)) for e in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        # every cell that reads the metric reports the metric it moves
        assert set(m.get("workloads", cells)) <= reported[m["moves"]], m["name"]
        assert "bound" not in m


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    cfg = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert os.path.isfile(os.path.join(ROOT, cfg["file"]))
    assert os.path.isfile(os.path.join(ROOT, "slam_bench", "traffic", f"{cell['traffic']}.json"))
    limits = load(os.path.join(ROOT, "slam_bench", "limits", f"{cell['name']}.json"))
    for number in ("pose_gap_p50_um", "map_miss_pct", "surfel_noise_mm"):
        assert limits[number] > 0
    assert limits.get("kf_drift_mm", 1.0) > 0
    assert cell["chips"] == 1
    for m in METRICS:
        if cell["name"] in m.get("workloads", [cell["name"]]):
            assert callable(importlib.import_module(f"slam_bench.metrics.{m['name']}").read)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_settings_are_the_ports_fields(name):
    from badslam_torch.config import BadSlamConfig

    cfg = load(os.path.join(ROOT, "slam_bench", "configs", f"{name}.json"))
    BadSlamConfig(**cfg["settings"])  # every key is a field of the program's config
    assert cfg["settings"]["fps_restriction"] == 0
    assert cfg["frames"] == 2600 and cfg["rate_hz"] == 30.0
    # reduced holds cuts of scale alone, each a key the file changes
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert set(entry["reduced"]) <= set(cfg["changed_from_defaults"])
    assert cfg["settings"]["enable_loop_detection"]
