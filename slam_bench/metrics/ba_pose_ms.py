"""Device milliseconds of BA's pose optimization per BA call replay (device
stamps, "BA pose optimization [graph]")."""


def read(record):
    timers = record["timing_s"]
    calls = timers.get("BA call [graph]", (0, 0.0))[0]
    if not calls or "BA pose optimization [graph]" not in timers:
        return None
    return 1e3 * timers["BA pose optimization [graph]"][1] / calls
