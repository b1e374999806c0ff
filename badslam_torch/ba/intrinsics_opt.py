"""Depth-deformation parameters owned by ``DirectBA``.

Counterpart of the parts of ``badslam_tpu/ba/intrinsics_opt.py`` that the
alternating BA without self-calibration needs: the identity depth
parameters (a = 0, cfactor = 0) that every frame's depth deformation reads.
Self-calibration (``optimize_intrinsics``, the Schur-complement intrinsics
step) comes with a later slice; ``frontend.check_supported`` refuses it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class DepthParams(NamedTuple):
    """Depth-deformation state (DepthParameters analog)."""

    a: torch.Tensor        # [] f32 global deformation parameter
    cfactor: torch.Tensor  # [Hc, Wc] f32 per-sparsification-cell factors


def cfactor_shape(height: int, width: int, cell_size: int) -> Tuple[int, int]:
    """Ceil-div grid, matching (w-1)/cell+1 (kernel_opt_intrinsics.cc:64)."""
    return ((height - 1) // cell_size + 1, (width - 1) // cell_size + 1)


def empty_depth_params(height: int, width: int, cell_size: int,
                       device: torch.device | str) -> DepthParams:
    return DepthParams(
        a=torch.zeros((), dtype=torch.float32, device=device),
        cfactor=torch.zeros(cfactor_shape(height, width, cell_size),
                            dtype=torch.float32, device=device))

