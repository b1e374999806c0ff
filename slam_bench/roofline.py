"""The yardstick of the kernels: the card's published peaks and the least
time each hand-written kernel could take on its inputs.

Copied from ``chip_smoke.py`` (``_bound``, ``_k1_ops`` and its peaks), so
that a later change to the program cannot move it.

Peaks (NVIDIA's H100 SXM data sheet, at the full 700 W power limit): HBM
3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s. A card set below
700 W reaches less, so every share is reported with the card's power
limit beside it.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# K2 (csrc/gather.cu): one thread per output, blocks of this many threads
# (at most 65536 blocks, the rest by grid stride).
K2_THREADS = 256
K1_NAME = "bilateral_filter_and_cutoff_kernel"
_K2_NAME = re.compile(r"gather_kernel<(int|long)")


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over the HBM rate, or operations over
    the float32 rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    h, w = img.shape
    padded = F.pad(img, (max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)))
    return padded[max(0, -dy) + dy:max(0, -dy) + dy + h,
                  max(0, -dx) + dx:max(0, -dx) + dx + w]


def k1_ops(depth: torch.Tensor, max_depth: float, radius: int) -> float:
    """Operations K1 does on this metric depth map: per valid center 2 (its
    inverse and the final division), per valid tap of a valid center 10
    (inverse, difference, square, two divisions, subtraction, exp, the
    weight's add, the value's multiply-add)."""
    center = (depth > 0) & (depth <= max_depth)
    taps = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx * dx + dy * dy <= radius * radius:
                taps += int((center & (_shift2d(depth, dy, dx) > 0)).sum())
    return 10.0 * taps + 2.0 * float(center.sum())


def k1_least_seconds(depth: torch.Tensor, max_depth: float, radius: int) -> float:
    """K1 on one [H, W] float32 depth map: reads it and writes the filtered
    map, 8 bytes a pixel."""
    return least_seconds(8.0 * depth.numel(), k1_ops(depth, max_depth, radius))


def k2_index_bytes(kernel_name: str) -> Optional[int]:
    """The index size of a K2 launch from its kernel name (int32 or int64
    indices), or None when the name is not K2's."""
    m = _K2_NAME.search(kernel_name)
    if m is None:
        return None
    return 4 if m.group(1) == "int" else 8


def k2_least_seconds(index_bytes: int, grid_x: int) -> float:
    """K2's least time from its launch: at least 256 * (blocks - 1) + 1
    outputs (the grid is min(ceil(outputs / 256), 65536) blocks), each
    reading its two indices and writing 4 bytes. The image reads are left
    out, as a gather may find them in cache, so the bound is a floor."""
    outputs = K2_THREADS * (grid_x - 1) + 1
    return least_seconds(outputs * (2.0 * index_bytes + 4.0), 0.0)
