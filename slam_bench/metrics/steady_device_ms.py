"""The device time of one steady-frame graph replay, from its first node to
its last (the program's device stamps, "steady frame [graph]"): the mean
over every steady replay of the window, those of keyframe frames and the
first after a BA call included, where ``steady_frame_ms`` is a median over
the other frames' event spans."""


def read(record):
    count, seconds = record["timing_s"].get("steady frame [graph]", (0, 0.0))
    return 1e3 * seconds / count if count else None
