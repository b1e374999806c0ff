"""Run one cell of the benchmark and print its result as the last line.

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is found by its name in
BENCHMARK.json (bench.load_cell). The window is --seconds of the cell's
recording (bench.window_intervals), the same frames on every run. The run needs the cell's CUDA devices and
never falls back to the CPU: without them it exits with code 2 and prints
no result. Earlier lines (standard output) carry the card's name and power
limit, the build, the rendering, the window and the program's counts;
the last lines of standard error each number the check compared beside
its limit; the last line of standard output is one JSON object: correct,
attempted (the window's frames), failed (those without a pose), metrics
(the end-to-end ones, or with --trace 1 the per-layer ones), device (and
with --trace 1 busy_s, window_s and breakdown), and last the checks.
A run that finds jax, jaxlib, flax or badslam_tpu loaded once the window
has closed exits with code 3 and prints no result.
"""

import time

_T_START = time.perf_counter()  # the set-up's start, before the imports

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m slam_bench.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from slam_bench import bench

    cell = bench.load_cell(args.workload)
    try:
        result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                _T_START, log=lambda s: print(s, flush=True))
    except bench.NoDevice as e:
        print(f"slam_bench: {e}", file=sys.stderr)
        return 2
    found = bench.forbidden_modules()
    if found:
        print(f"slam_bench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
