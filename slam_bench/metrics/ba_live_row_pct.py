"""The share of the surfel bucket's rows that hold a valid surfel, over BA's
passes in the window (the program's device counters "BA live surfels
[graph]" and "BA surfel rows [graph]")."""


def read(record):
    timers = record["timing_s"]
    rows = timers.get("BA surfel rows [graph]", (0, 0.0))[0]
    if not rows:
        return None
    return 100.0 * timers.get("BA live surfels [graph]", (0, 0.0))[0] / rows
