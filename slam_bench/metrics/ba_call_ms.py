"""The mean device time of the window's BA calls (keyframe calls and
drains; DirectBA.ba_spans, CUDA events)."""


def read(record):
    ms = record["ba_ms"]
    return sum(ms) / len(ms) if ms else None
