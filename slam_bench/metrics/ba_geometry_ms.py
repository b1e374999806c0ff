"""Device milliseconds of BA's geometry optimization (surfel activation,
normals, positions and descriptors) per BA call replay (device stamps,
"BA geometry optimization [graph]")."""


def read(record):
    timers = record["timing_s"]
    calls = timers.get("BA call [graph]", (0, 0.0))[0]
    if not calls or "BA geometry optimization [graph]" not in timers:
        return None
    return 1e3 * timers["BA geometry optimization [graph]"][1] / calls
