"""Shared pieces of the benchmark's CPU tests: the tiny cell."""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "slam_bench", "tests", "data")


def load(path):
    with open(path) as f:
        return json.load(f)


def tiny_cell(mix: str = "turn") -> dict:
    """A cell at 64x48 on the CPU: tests/data/tiny.json, the mix
    tests/data/<mix>.json or traffic/<mix>.json, tests/data/tiny_limits.json,
    and BENCHMARK.json's metrics."""
    from slam_bench import scene

    path = os.path.join(DATA, f"{mix}.json")
    bench = load(os.path.join(ROOT, "BENCHMARK.json"))
    return {"workload": {"name": "tiny", "chips": 1},
            "config": load(os.path.join(DATA, "tiny.json")),
            "mix": load(path) if os.path.exists(path) else scene.load_mix(mix),
            "limits": load(os.path.join(DATA, "tiny_limits.json")),
            "end_to_end": bench["end_to_end"], "per_layer": bench["per_layer"]}
