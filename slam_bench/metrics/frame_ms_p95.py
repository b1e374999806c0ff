"""The 95th percentile over the window's untraced frames of each frame's
time (as frame_ms_p50): where the keyframe and BA-drain frames sit."""

import numpy as np


def read(record):
    lat = record["latency_ms"][record["slice_frames"]:]
    return float(np.percentile(lat, 95)) if lat else None
