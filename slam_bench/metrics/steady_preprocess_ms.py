"""The device time of the steady frame's preprocessing and pyramid per
steady-frame graph replay, from the first node of ``preprocess_frame`` (K1,
the depth cutoff, normals, radii) to the last of ``build_pyramid`` (the
program's device stamps, "steady frame: preprocess [graph]"): the mean over
every steady replay of the window, as ``steady_device_ms`` takes the whole
replay's. A program without the stamp gives nothing to read."""


def read(record):
    count, seconds = record["timing_s"].get("steady frame: preprocess [graph]", (0, 0.0))
    return 1e3 * seconds / count if count else None
