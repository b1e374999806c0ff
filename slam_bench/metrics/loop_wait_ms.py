"""The frame loop's wait for the loop-detection worker (the program's timer
"loop detection drain (wait)"), per keyframe of the window."""


def read(record):
    kfs = record["keyframe_frames"]
    if not kfs:
        return None
    _, seconds = record["timing_s"].get("loop detection drain (wait)", (0, 0.0))
    return 1e3 * seconds / len(kfs)
