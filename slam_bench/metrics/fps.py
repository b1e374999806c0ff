"""Frames completed in the window over its wall seconds (host clock; the
window ends with a synchronize)."""


def read(record):
    return record["frames"] / record["window_s"] if record["frames"] else None
