"""The 95th percentile of the window's untraced frames' times (as
frame_ms_p95), read in the traced run of the cells where the seed moves
the BA-carrying frames' tail too far for a bound (PERF.md)."""

from slam_bench.metrics import frame_ms_p95


def read(record):
    return frame_ms_p95.read(record)
