"""Process start to the window's start: build or load of the CUDA
sources, rendering, the program's construction and the warm-up."""


def read(record):
    return record["setup_s"]
