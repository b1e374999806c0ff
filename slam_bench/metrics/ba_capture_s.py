"""Capture plus instantiation seconds of the BA graphs captured in the
window (a new call kind or bucket captures anew)."""


def read(record):
    return sum(c["capture_s"] + c["instantiate_s"] for c in record["captures"])
