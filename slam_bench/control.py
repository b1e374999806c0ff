"""The controls of the check: the same runs, with the reference in a lower
precision judged in the program's place beside the program.

    python3 -m slam_bench.control --workload <cell> --seeds 1,2,3 --seconds 10

For each seed: one untraced run of the cell (set-up, warm-up, window), then
check.py's numbers for the program and for each control ("tf32": the
reference's matrix products in TF32; "bf16": TF32 and bfloat16 planes, map
and keyframe poses). With ``--fault`` a fault of faults.py is planted in the
program for the runs. Prints one JSON line per seed. The benchmark's own
runs do not run it; it gives the readings that the limits in
limits/<cell>.json were set between (PERF.md).
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m slam_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--controls", default="tf32,bf16")
    p.add_argument("--fault", default="", help="a fault of faults.py, planted in the program")
    args = p.parse_args(argv)

    import contextlib

    from slam_bench import bench, faults

    cell = bench.load_cell(args.workload)
    controls = [c for c in args.controls.split(",") if c]
    start = _T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            r = bench.run_cell(cell, seed, args.seconds, False, "cuda", start,
                               log=lambda s: print(s, flush=True), controls=controls)
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": r["correct"],
                          "metrics": r["metrics"],
                          "program": r["checks"], "controls": r.get("controls", {})}),
              flush=True)
        start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
