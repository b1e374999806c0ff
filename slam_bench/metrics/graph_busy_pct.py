"""The card's share of the untraced window spent inside the program's CUDA
graphs: the device-stamped seconds of the whole steady-frame, BA-call and
closure-attempt replays (their WHILE bodies included) over the window's
wall seconds. In a traced run the window follows the profiled slice, and
the profiler's hooks, still attached, slow the host's launches: the share
reads a few points lower than in an untraced run."""

REPLAYS = ("steady frame [graph]", "BA call [graph]", "closure attempt [graph]")


def read(record):
    timers = record["timing_s"]
    if not any(name in timers for name in REPLAYS) or record["post_wall_s"] <= 0:
        return None
    busy = sum(timers.get(name, (0, 0.0))[1] for name in REPLAYS)
    return 100.0 * busy / record["post_wall_s"]
