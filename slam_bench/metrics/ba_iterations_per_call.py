"""BA iterations per BA call replay: runs of the iteration body over the
replays of the BA call's graph (device stamps)."""


def read(record):
    timers = record["timing_s"]
    calls = timers.get("BA call [graph]", (0, 0.0))[0]
    if not calls:
        return None
    return timers.get("BA iteration [graph]", (0, 0.0))[0] / calls
