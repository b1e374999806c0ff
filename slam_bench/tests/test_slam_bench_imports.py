"""What the benchmark loads: nothing of JAX or the JAX package in the
harness, and nothing of the program in the reference; and a run without a
card fails without a result. Each in a fresh interpreter, with top-level
module names compared whole (badslam_torch and badslam_tpu share a
prefix)."""

import json
import subprocess
import sys

import pytest

from slam_bench.tests.helpers import ROOT

JAX = {"jax", "jaxlib", "flax", "badslam_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _loaded("import slam_bench.run, slam_bench.bench, slam_bench.check, "
                   "slam_bench.trace, slam_bench.control, slam_bench.faults\n"
                   "import importlib, os\n"
                   "for f in os.listdir('slam_bench/metrics'):\n"
                   "    f.endswith('.py') and importlib.import_module('slam_bench.metrics.' + f[:-3])\n"
                   "import badslam_torch.frontend")
    assert "badslam_torch" in mods
    assert not mods & JAX, mods & JAX


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import slam_bench.reference.tracker, slam_bench.reference.frame, "
                   "slam_bench.reference.geometry, slam_bench.check")
    assert not mods & (JAX | {"badslam_torch"}), mods & (JAX | {"badslam_torch"})


def test_a_run_without_a_card_fails_without_a_result():
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['slam_bench.run', '--workload', 'tum_vga.desk_hover', '--seed',"
            " '5', '--seconds', '1', '--trace', '0']\n"
            "runpy.run_module('slam_bench.run', run_name='__main__')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode != 0
    assert '"metrics"' not in p.stdout and "correct" not in p.stdout
    found = {m for m in JAX if f"'{m}'" in p.stderr}
    assert not found


@pytest.mark.parametrize("workload", ["tum_vga_no_loop.corridor_walk", "tum_vga.desk_hover"])
def test_no_result_where_the_program_is_missing(tmp_path, workload):
    """A checkout holding only BENCHMARK.json and slam_bench/ has no program."""
    import shutil

    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{ROOT}/slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = subprocess.run([sys.executable, "-m", "slam_bench.run", "--workload", workload,
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and '"metrics"' not in p.stdout
