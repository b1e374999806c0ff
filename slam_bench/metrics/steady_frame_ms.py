"""The median span of the frames that are neither keyframes nor carry a BA
drain: the steady frame (K1, pyramid, tracker as one graph replay)."""

import numpy as np


def read(record):
    skip = set(record["keyframe_frames"]) | set(record["drain_frames"])
    ms = [v for f, v in record["span_ms"].items() if f not in skip]
    return float(np.median(ms)) if ms else None
