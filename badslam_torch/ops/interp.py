"""Image gather / bilinear interpolation (texture-read substitutes).

Counterpart of ``badslam_tpu/ops/interp.py``. Coordinates use the
pixel-corner convention (texel centers at integer + 0.5) with clamp-to-edge
addressing.

``gather_nearest`` is the one place where every image read at integer
pixel indices goes through: on a CUDA tensor it launches K2
(``csrc/gather.cu``), on a CPU tensor it runs ``gather_nearest_plain``.
``gather_onehot`` (K3 and ``gather_onehot_plain``) is the probe's windowed
variant and is not used by the SLAM path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from badslam_torch.ops import kernels

# The one-hot gather's row blocks and the rows of padding on each side of
# the window (tools/probe_pallas_gather.py:120, block_h 8, pad 4).
ONEHOT_BLOCK_ROWS = 8
ONEHOT_PAD = 4


def gather_nearest_plain(img: torch.Tensor, px: torch.Tensor,
                         py: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: ``img[py, px]`` with jnp.take's fill
    semantics on the flat index ``py * W + px``: an index in [-H*W, 0) wraps
    once to ``+ H*W``, an index outside [-H*W, H*W) gives NaN.

    `img` is [H, W] with px/py of any one shape, or [B, H, W] with px/py
    [B, ...] (one gather per image, the JAX package's vmap)."""
    h, w = img.shape[-2:]
    size = h * w
    idx = py.to(torch.int64) * w + px.to(torch.int64)
    idx = torch.where(idx < 0, idx + size, idx)
    outside = (idx < 0) | (idx >= size)
    idx = torch.where(outside, 0, idx)
    if img.ndim == 2:
        out = img.reshape(-1)[idx.reshape(-1)].reshape(px.shape)
    else:
        b = img.shape[0]
        out = torch.gather(img.reshape(b, size), 1,
                           idx.reshape(b, -1)).reshape(px.shape)
    return torch.where(outside, float("nan"), out)


def gather_nearest(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """img[py, px] for integer index tensors (see gather_nearest_plain for
    the shapes and the out-of-range rule): K2 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if img.is_cuda:
        b = img.shape[0] if img.ndim == 3 else 1
        h, w = img.shape[-2:]
        out = kernels.gather_cuda(img.contiguous().reshape(b, h, w),
                                  px.contiguous().reshape(b, -1),
                                  py.contiguous().reshape(b, -1))
        return out.reshape(px.shape)
    if img.device.type != "cpu":
        raise ValueError(f"no gather for device {img.device}")
    return gather_nearest_plain(img, px, py)


def gather_onehot_plain(img: torch.Tensor, px: torch.Tensor,
                        py: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3 on an [H, W] image with [H, W] indices:
    for output row y in the 8-row block i = y // 8, ``img[py, px]`` where
    8i - 4 <= py < 8i + 12 and both indices lie in the image, else 0."""
    h, w = img.shape
    lo = (torch.arange(h, device=img.device) // ONEHOT_BLOCK_ROWS
          * ONEHOT_BLOCK_ROWS - ONEHOT_PAD)[:, None]
    py = py.to(torch.int64)
    px = px.to(torch.int64)
    hit = ((py >= lo) & (py < lo + ONEHOT_BLOCK_ROWS + 2 * ONEHOT_PAD)
           & (py >= 0) & (py < h) & (px >= 0) & (px < w))
    idx = torch.where(hit, py * w + px, 0)
    return torch.where(hit, img.reshape(-1)[idx], 0.0)


def gather_onehot(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """The windowed one-hot gather: K3 on a CUDA tensor, the plain version
    on a CPU tensor."""
    if img.is_cuda:
        return kernels.gather_onehot_cuda(img.contiguous(), px.contiguous(),
                                          py.contiguous())
    if img.device.type != "cpu":
        raise ValueError(f"no one-hot gather for device {img.device}")
    return gather_onehot_plain(img, px, py)


def quad_texels(h: int, w: int, x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The 2x2 texel indices of corner-convention coords (x, y) in an
    [h, w] image and the weights between them.

    Returns (ix0, iy0, ix1, iy1, tx, ty) with ix = floor(max(0, x - 0.5)),
    tx clamped to [0, 1] and texel indices clamped to the image border.
    """
    fx = torch.clamp_min(x - 0.5, 0.0)
    fy = torch.clamp_min(y - 0.5, 0.0)
    ix = torch.floor(fx)
    iy = torch.floor(fy)
    tx = torch.clamp(fx - ix, 0.0, 1.0)
    ty = torch.clamp(fy - iy, 0.0, 1.0)
    ix = ix.to(torch.int64)
    iy = iy.to(torch.int64)
    return (torch.clamp(ix, 0, w - 1), torch.clamp(iy, 0, h - 1),
            torch.clamp(ix + 1, 0, w - 1), torch.clamp(iy + 1, 0, h - 1), tx, ty)


def gather_quad(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The 2x2 texel neighborhood of corner-convention coords (x, y) (see
    `quad_texels`): (top_left, top_right, bottom_left, bottom_right, tx, ty).
    """
    ix0, iy0, ix1, iy1, tx, ty = quad_texels(*img.shape[-2:], x, y)
    tl = gather_nearest(img, ix0, iy0)
    tr = gather_nearest(img, ix1, iy0)
    bl = gather_nearest(img, ix0, iy1)
    br = gather_nearest(img, ix1, iy1)
    return tl, tr, bl, br, tx, ty


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at corner-convention coords."""
    tl, tr, bl, br, tx, ty = gather_quad(img, x, y)
    top = tl + tx * (tr - tl)
    bottom = bl + tx * (br - bl)
    return top + ty * (bottom - top)


def bilinear_and_gradient(
    img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(value, d/dx, d/dy) of the bilinear patch at corner coords (x, y):
    dx = (br-bl)*ty + (tr-tl)*(1-ty); dy = (br-tr)*tx + (bl-tl)*(1-tx)."""
    tl, tr, bl, br, tx, ty = gather_quad(img, x, y)
    top = tl + tx * (tr - tl)
    bottom = bl + tx * (br - bl)
    value = top + ty * (bottom - top)
    dx = (br - bl) * ty + (tr - tl) * (1.0 - ty)
    dy = (br - tr) * tx + (bl - tl) * (1.0 - tx)
    return value, dx, dy
