"""The loop-detection worker's time (the program's timer "loop detection
(worker thread)", host clock) per keyframe inserted in the window."""


def read(record):
    timers = record["timing_s"]
    keyframes = timers.get("keyframe insert", (0, 0.0))[0]
    if not keyframes or "loop detection (worker thread)" not in timers:
        return None
    return 1e3 * timers["loop detection (worker thread)"][1] / keyframes
