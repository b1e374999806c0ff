"""On a card: each cell runs briefly from the command line and is correct."""

import json
import subprocess
import sys

import pytest
import torch

from slam_bench.tests.helpers import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tum_vga.corridor_walk", "tum_vga.desk_hover"])
def test_cell_runs_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "slam_bench.run", "--workload", workload,
                        "--seed", "2147483999", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tum_vga.corridor_walk", "tum_vga.desk_hover"])
def test_ba_left_frozen_is_caught_on_the_card(workload):
    """BA's optimisation left out, its surfel bookkeeping kept
    (faults.ba_frozen), at the cell's own size: correct comes out false."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "slam_bench.control", "--workload", workload,
                        "--seeds", "2147483998", "--seconds", "10", "--controls", "",
                        "--fault", "ba_frozen"], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert not result["correct"], result["program"]
