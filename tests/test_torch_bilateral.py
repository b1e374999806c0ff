"""The arithmetic of the bilateral filter's CUDA kernel (K1,
badslam_torch/csrc/bilateral.cu), emulated on the CPU and held to the
plain version (badslam_torch/ops/preprocess.py::bilateral_filter_and_cutoff).

The kernel cannot run here, so this file checks its formula, not its code:
the staged inverse depths (1/d where d > 0, else 0, which marks the sample
invalid), the per-tap spatial constants, the multiply by the float32
reciprocal constants that the launcher rounds from double, the approximate
exponential 2^x with every weight scaled by an independent random factor in
[1 - 2^-21, 1 + 2^-21] (twice the 2 ulp that the PTX ISA gives
ex2.approx.f32), the validity of each tap as a select, the taps summed in
the plain order. tests/test_torch_cuda.py holds the kernel itself to the
plain version on the card.

Tolerance: atol 1e-5, the kernel's own hold against the plain version
(outputs are depths of 0.5-3 m).
"""

import numpy as np
import pytest
import torch

from badslam_torch import synthetic
from badslam_torch.ops.preprocess import bilateral_filter_and_cutoff, shift2d

torch.set_num_threads(1)

ATOL = 1e-5
LOG2E = 1.4426950408889634
EX2_REL_ERR = 2.0 ** -21
# (sigma_xy, radius_factor, sigma_inv_depth) -> radius 2, 3 (the defaults), 5.
RADII = {2: (1.0, 2.0, 0.01), 3: (1.5, 2.0, 0.005), 5: (2.5, 2.0, 0.005)}


def emulate_kernel(depth: torch.Tensor, max_depth: float, sigma_xy: float,
                   radius_factor: float, sigma_inv_depth: float,
                   rng: np.random.Generator) -> torch.Tensor:
    """K1's arithmetic in float32 on the CPU (see the module docstring)."""
    radius = int(radius_factor * sigma_xy + 0.5)
    # The wrapper passes 2 sigma^2 as float32; the launcher divides log2(e)
    # by it in double and rounds the result to float32.
    neg_k_xy = np.float32(-LOG2E / float(np.float32(2.0 * sigma_xy * sigma_xy)))
    neg_k_value = np.float32(
        -LOG2E / float(np.float32(2.0 * sigma_inv_depth * sigma_inv_depth)))
    inv = torch.where(depth > 0, 1.0 / torch.where(depth > 0, depth, 1.0), 0.0)
    weight_sum = torch.zeros_like(depth)
    value_sum = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            dist_sq = dx * dx + dy * dy
            if dist_sq > radius * radius:
                continue
            sample = shift2d(inv, dy, dx)  # 0 outside the image: invalid
            k_spatial = torch.tensor(np.float32(dist_sq) * neg_k_xy)
            diff = inv - sample
            w = torch.exp2(diff * diff * torch.tensor(neg_k_value) + k_spatial)
            w = w * torch.from_numpy(rng.uniform(
                1.0 - EX2_REL_ERR, 1.0 + EX2_REL_ERR, depth.shape).astype(np.float32))
            w = torch.where(sample > 0, w, 0.0)
            weight_sum = weight_sum + w
            value_sum = value_sum + w * sample
    out = torch.where(weight_sum > 0,
                      weight_sum / torch.clamp_min(value_sum, 1e-30), 0.0)
    return torch.where((depth > 0) & (depth <= max_depth), out, 0.0)


def random_depth(seed, shape, max_depth=2.5):
    """chip_smoke.py's input: 0.5-3 m, 15% invalid, 5% beyond the cutoff."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    d[rng.uniform(size=shape) < 0.15] = 0.0
    d[rng.uniform(size=shape) < 0.05] = max_depth + 2.0
    return torch.from_numpy(d)


def rendered_vga_depth(seed=7):
    """What the main path feeds K1: a rendered 640x480 plane scene as raw
    u16 depth scaled to metres in float32, smooth and almost all valid."""
    cam = synthetic.default_camera(640, 480)
    scene = synthetic.random_plane_scene(np.random.default_rng(seed), 6)
    depth, _ = synthetic.render_scene(cam, scene, synthetic.pose(tx=0.01, rz=0.02))
    raw = np.clip(depth * 5000.0, 0, 65535).astype(np.int32)
    return torch.from_numpy(raw).to(torch.float32) * (1.0 / 5000.0)


def _check(depth, max_depth, radius, seed):
    sigma_xy, radius_factor, sigma_inv = RADII[radius]
    assert int(radius_factor * sigma_xy + 0.5) == radius
    ref = bilateral_filter_and_cutoff(depth, max_depth, sigma_xy, radius_factor, sigma_inv)
    out = emulate_kernel(depth, max_depth, sigma_xy, radius_factor, sigma_inv,
                         np.random.default_rng(seed))
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    # The same pixels are valid, and there is filtering to compare.
    assert torch.equal(out > 0, ref > 0)
    assert bool((ref > 0).any()) or depth.numel() < 4


@pytest.mark.parametrize("radius", sorted(RADII), ids=lambda r: f"r{r}")
@pytest.mark.parametrize("shape", [(480, 640), (67, 160), (5, 3), (1, 1), (33, 70)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_arithmetic_matches_plain(shape, radius):
    _check(random_depth(sum(shape), shape), 2.5, radius, seed=radius)


@pytest.mark.parametrize("radius", sorted(RADII), ids=lambda r: f"r{r}")
def test_kernel_arithmetic_matches_plain_on_rendered_frame(radius):
    depth = rendered_vga_depth()
    assert float((depth > 0).float().mean()) > 0.9
    _check(depth, 3.0, radius, seed=10 + radius)
