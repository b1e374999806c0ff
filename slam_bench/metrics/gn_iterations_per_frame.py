"""The steady frames' Gauss-Newton iterations (all scales, the program's
device counter) per frame."""


def read(record):
    frames = record["post_frames"]
    return record["gn_iterations"] / len(frames) if frames else None
