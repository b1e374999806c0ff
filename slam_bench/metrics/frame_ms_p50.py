"""The median over all frames of the window of each frame's time: from the
previous frame's pose write to its own, on the benchmark's CUDA events."""

import numpy as np


def read(record):
    lat = record["latency_ms"]
    return float(np.percentile(lat, 50)) if lat else None
