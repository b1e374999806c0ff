"""K2's share of its roofline in the traced slice: its least time per
launch (roofline.k2_least_seconds, from the launch's grid and index type)
over the profiler's K2 kernel time."""

from slam_bench import roofline


def read(record):
    t = record["trace"]
    if not t or not t.get("found") or not t["k2"]:
        return None
    least = sum(roofline.k2_least_seconds(size, grid) for _, size, grid in t["k2"])
    return 100.0 * least / sum(d for d, _, _ in t["k2"])
