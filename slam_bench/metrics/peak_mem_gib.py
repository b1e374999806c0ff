"""The most device memory allocated over set-up and window, in GiB (the
map, the keyframes and the graph pools)."""


def read(record):
    return record["peak_bytes"] / 2**30 if record["peak_bytes"] else None
