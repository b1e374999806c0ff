"""K1's share of its roofline in the traced slice: its least time on each
frame's depth (roofline.k1_least_seconds: the bytes it must move or the
operations it must do) over the profiler's K1 kernel time. One launch per
frame; where the launches and the frames do not pair, nothing is read."""


def read(record):
    t = record["trace"]
    least = record["k1_least_s"]
    if not t or not t.get("found") or not least or len(t["k1"]) != len(least):
        return None
    return 100.0 * sum(least) / sum(t["k1"])
