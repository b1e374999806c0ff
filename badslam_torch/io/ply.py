"""Binary PLY point-cloud export (libvis point_cloud.h:487-529 analog).

Counterpart of ``badslam_tpu/io/ply.py``: the same header and the same
bytes per vertex (x y z as float, optional nx ny nz as float, optional red
green blue as uchar, little endian), written in one pass from a numpy
record array.
"""

from __future__ import annotations

import numpy as np


def save_ply(path: str, positions: np.ndarray, normals: np.ndarray = None,
             colors: np.ndarray = None) -> None:
    """positions [N, 3], normals [N, 3] (optional), colors [N, 3] in
    [0, 255] (optional; clipped and truncated to u8)."""
    n = len(positions)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    props = ["property float x", "property float y", "property float z"]
    if normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        props += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    rows = np.empty(n, dtype=np.dtype(fields))
    pos = np.asarray(positions, np.float32).reshape(n, 3)
    rows["x"], rows["y"], rows["z"] = pos.T
    if normals is not None:
        nrm = np.asarray(normals, np.float32).reshape(n, 3)
        rows["nx"], rows["ny"], rows["nz"] = nrm.T
    if colors is not None:
        col = np.clip(np.asarray(colors), 0, 255).astype(np.uint8).reshape(n, 3)
        rows["red"], rows["green"], rows["blue"] = col.T
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rows.tobytes())
