"""Window wall time not covered by any of the program's frame spans, per
frame (the host's share of the frame loop: Python between replays, the
loop worker holding the interpreter, waits)."""


def read(record):
    frames = record["post_frames"]
    spans = record["span_ms"]
    if not frames or len(spans) != len(frames):
        return None
    return (1e3 * record["post_wall_s"] - sum(spans.values())) / len(frames)
