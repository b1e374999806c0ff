"""Per-frame preprocessing, the image pyramid and the image reads of the
reference tracker.

A frozen copy of the port's plain PyTorch versions (``ops/preprocess.py``
with the plain bilateral filter in place of K1, ``ops/pyramid.py``,
``ops/interp.py`` with the plain gather in place of K2, ``ops/robust.py``)
as they stood when the benchmark was defined. The undistortion, median
filter and input-pyramid stages are left out: no configuration of the
benchmark uses them. It imports nothing of the program.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from slam_bench.reference.geometry import PinholeCamera


DEPTH_RESIDUAL_WEIGHT = 1.0


DEPTH_TUKEY_PARAM = 10.0


DEPTH_UNCERTAINTY_EMPIRICAL_FACTOR = 0.1


DESCRIPTOR_RESIDUAL_WEIGHT = 1e-2


DESCRIPTOR_HUBER_PARAM = 10.0


COS_NORMAL_COMPATIBILITY_THRESHOLD = 0.76604


def tukey_weight(r: torch.Tensor, param) -> torch.Tensor:
    quot = r / param
    term = 1.0 - quot * quot
    return torch.where(torch.abs(r) < param, term * term, 0.0)


def tukey_residual(r: torch.Tensor, param) -> torch.Tensor:
    quot = r / param
    term = 1.0 - quot * quot
    inside = (param * param / 6.0) * (1.0 - term * term * term)
    return torch.where(torch.abs(r) < param, inside, param * param / 6.0)


def huber_weight(r: torch.Tensor, param) -> torch.Tensor:
    abs_r = torch.abs(r)
    return torch.where(abs_r < param, 1.0, param / torch.clamp_min(abs_r, 1e-30))


def huber_residual(r: torch.Tensor, param) -> torch.Tensor:
    abs_r = torch.abs(r)
    return torch.where(
        abs_r < param, 0.5 * r * r, param * (abs_r - 0.5 * param)
    )


def depth_residual_weight(r, scaling=1.0):
    return DEPTH_RESIDUAL_WEIGHT * tukey_weight(r, scaling * DEPTH_TUKEY_PARAM)


def weighted_depth_residual(r, scaling=1.0):
    return DEPTH_RESIDUAL_WEIGHT * tukey_residual(r, scaling * DEPTH_TUKEY_PARAM)


def descriptor_residual_weight(r, scaling=1.0):
    return scaling * DESCRIPTOR_RESIDUAL_WEIGHT * huber_weight(r, DESCRIPTOR_HUBER_PARAM)


def weighted_descriptor_residual(r, scaling=1.0):
    return scaling * DESCRIPTOR_RESIDUAL_WEIGHT * huber_residual(r, DESCRIPTOR_HUBER_PARAM)



class ProcessedFrame(NamedTuple):
    """All derived per-frame data used by tracking (finest scale)."""

    depth: torch.Tensor      # [H, W] f32 calibrated meters, 0 = invalid
    nx: torch.Tensor         # [H, W] f32 image-space normal x
    ny: torch.Tensor         # [H, W] f32 image-space normal y
    radius2: torch.Tensor    # [H, W] f32 squared point radius (0 where invalid)
    intensity: torch.Tensor  # [H, W] f32 in [0, 1]
    # Filtered metric depth before the deformation model.
    raw_depth: Optional[torch.Tensor] = None
    # Original color image [H, W, 3] u8.
    rgb: Optional[torch.Tensor] = None


def shift2d(img: torch.Tensor, dy: int, dx: int, fill: float = 0.0) -> torch.Tensor:
    """Shifted view: out[y, x] = img[y + dy, x + dx], `fill` outside."""
    h, w = img.shape
    pad_top = max(0, -dy)
    pad_bottom = max(0, dy)
    pad_left = max(0, -dx)
    pad_right = max(0, dx)
    padded = F.pad(img, (pad_left, pad_right, pad_top, pad_bottom), value=fill)
    return padded[pad_top + dy:pad_top + dy + h, pad_left + dx:pad_left + dx + w]


def _pixel_grid(h: int, w: int, like: torch.Tensor):
    """Integer pixel index planes (ys, xs) as float [H, W] on `like`'s device."""
    ys = torch.arange(h, device=like.device, dtype=like.dtype)[:, None].expand(h, w)
    xs = torch.arange(w, device=like.device, dtype=like.dtype)[None, :].expand(h, w)
    return ys, xs


def compute_brightness(rgb: torch.Tensor) -> torch.Tensor:
    """RGB u8 [H, W, 3] -> intensity f32 [0, 1] (Rec.601 luma, u8-quantized)."""
    rgbf = rgb.to(torch.float32)
    luma = 0.299 * rgbf[..., 0] + 0.587 * rgbf[..., 1] + 0.114 * rgbf[..., 2]
    return torch.floor(luma + 0.5) * (1.0 / 255.0)


def _cfactor_plane(cfactor: torch.Tensor, h: int, w: int, cell_size: int) -> torch.Tensor:
    ys = torch.arange(h, device=cfactor.device) // cell_size
    xs = torch.arange(w, device=cfactor.device) // cell_size
    return cfactor[ys[:, None], xs[None, :]]


def apply_depth_deformation(
    depth: torch.Tensor,
    a: torch.Tensor,
    cfactor: torch.Tensor,
    cell_size: int = 4,
) -> torch.Tensor:
    """Depth deformation model 1/(1/d + cfactor*exp(-a/d)); 0 stays invalid.

    Runs for identity parameters too (a = 0, cfactor all zero), as the JAX
    front end does: 1/(1/d + 0) is not bit-equal to d.
    """
    h, w = depth.shape
    valid = depth > 0
    inv_d = 1.0 / torch.where(valid, depth, 1.0)
    cf = _cfactor_plane(cfactor, h, w, cell_size)
    out = 1.0 / (inv_d + cf * torch.exp(-a * inv_d))
    return torch.where(valid, out, 0.0)


def bilateral_filter_and_cutoff(
    depth: torch.Tensor,
    max_depth: float,
    sigma_xy: float = 1.5,
    radius_factor: float = 2.0,
    sigma_inv_depth: float = 0.005,
) -> torch.Tensor:
    """Bilateral filter on inverse depth + max-depth cutoff (plain version).

    Gaussian in pixel distance and in inverse-depth difference to the
    center pixel over the disk dx^2 + dy^2 <= r^2, r = int(radius_factor *
    sigma_xy + 0.5) (29 taps at the defaults); invalid (0) and out-of-image
    samples are skipped; a center that is invalid or beyond max_depth gives
    an invalid output. The max-depth test applies to the center only.
    """
    radius = int(radius_factor * sigma_xy + 0.5)
    radius_sq = radius * radius
    denom_xy = 2.0 * sigma_xy * sigma_xy
    denom_value = 2.0 * sigma_inv_depth * sigma_inv_depth

    center_valid = (depth > 0) & (depth <= max_depth)
    inv_center = 1.0 / torch.where(center_valid, depth, 1.0)

    weight_sum = torch.zeros_like(depth)
    value_sum = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            grid_dist_sq = dx * dx + dy * dy
            if grid_dist_sq > radius_sq:
                continue
            sample = shift2d(depth, dy, dx)
            sample_valid = sample > 0
            inv_sample = 1.0 / torch.where(sample_valid, sample, 1.0)
            diff = inv_center - inv_sample
            w = torch.where(
                sample_valid,
                torch.exp(-grid_dist_sq / denom_xy - (diff * diff) / denom_value),
                0.0,
            )
            weight_sum = weight_sum + w
            value_sum = value_sum + w * inv_sample
    out = torch.where(weight_sum > 0,
                      weight_sum / torch.clamp_min(value_sum, 1e-30), 0.0)
    return torch.where(center_valid, out, 0.0)


def _unproject_planes(cam: PinholeCamera, depth: torch.Tensor):
    h, w = depth.shape
    ys, xs = _pixel_grid(h, w, depth)
    px = depth * (cam.fx_inv * xs + cam.cx_inv)
    py = depth * (cam.fy_inv * ys + cam.cy_inv)
    return px, py, depth


def compute_normals(
    cam: PinholeCamera, depth: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Central-difference normals with occlusion-aware side selection.

    Returns (out_depth, nx, ny); pixels lacking any of the 4 neighbors (or
    at the 1-px border) are invalidated. nz is implicitly
    -sqrt(1 - nx^2 - ny^2).
    """
    h, w = depth.shape
    px, py, pz = _unproject_planes(cam, depth)

    def neighbor(dy, dx):
        return shift2d(depth, dy, dx), shift2d(px, dy, dx), shift2d(py, dy, dx)

    dl, lx, ly = neighbor(0, -1)
    dr, rx, ry = neighbor(0, 1)
    dt, tx, ty = neighbor(-1, 0)
    db, bx, by = neighbor(1, 0)

    ys, xs = _pixel_grid(h, w, depth)
    interior = (xs >= 1) & (ys >= 1) & (xs < w - 1) & (ys < h - 1)
    valid = interior & (depth > 0) & (dl > 0) & (dr > 0) & (dt > 0) & (db > 0)

    ratio_thr_sq = 4.0  # kRatioThreshold = 2

    def pick_pair(n1x, n1y, n1z, n2x, n2y, n2z):
        """Difference vector between two opposite neighbors: n2-n1 if their
        distances to the center are comparable, else the closer side's."""
        d1_sq = (n1x - px) ** 2 + (n1y - py) ** 2 + (n1z - pz) ** 2
        d2_sq = (n2x - px) ** 2 + (n2y - py) ** 2 + (n2z - pz) ** 2
        ratio = d1_sq / torch.clamp_min(d2_sq, 1e-30)
        both = (ratio < ratio_thr_sq) & (ratio > 1.0 / ratio_thr_sq)
        use_side1 = d1_sq < d2_sq
        vx = torch.where(both, n2x - n1x, torch.where(use_side1, px - n1x, n2x - px))
        vy = torch.where(both, n2y - n1y, torch.where(use_side1, py - n1y, n2y - py))
        vz = torch.where(both, n2z - n1z, torch.where(use_side1, pz - n1z, n2z - pz))
        return vx, vy, vz

    ax, ay, az = pick_pair(lx, ly, dl, rx, ry, dr)       # left -> right
    bx_, by_, bz_ = pick_pair(bx, by, db, tx, ty, dt)    # bottom -> top

    # normal = cross(left_to_right, bottom_to_top)
    nx = ay * bz_ - az * by_
    ny = az * bx_ - ax * bz_
    nz = ax * by_ - ay * bx_
    length = torch.sqrt(nx * nx + ny * ny + nz * nz)
    sign = -1.0 if cam.fy_inv < 0 else 1.0
    inv_len = sign / torch.clamp_min(length, 1e-30)
    degenerate = length <= 1e-6
    nx = torch.where(degenerate, 0.0, nx * inv_len)
    ny = torch.where(degenerate, 0.0, ny * inv_len)

    out_depth = torch.where(valid, depth, 0.0)
    nx = torch.where(valid, nx, 0.0)
    ny = torch.where(valid, ny, 0.0)
    return out_depth, nx, ny


def normal_z(nx: torch.Tensor, ny: torch.Tensor) -> torch.Tensor:
    """Reconstruct nz (camera-facing, negative) from the stored components."""
    return -torch.sqrt(torch.clamp_min(1.0 - nx * nx - ny * ny, 0.0))


def compute_radii_and_remove_isolated(
    cam: PinholeCamera, depth: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared point radius = min squared distance to the 4-neighbor points.

    Pixels with fewer than 4 valid axis-neighbors are invalidated.
    """
    px, py, pz = _unproject_planes(cam, depth)
    min_dist_sq = torch.full_like(depth, float("inf"))
    count = torch.zeros(depth.shape, dtype=torch.int32, device=depth.device)
    for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0)):
        nd = shift2d(depth, dy, dx)
        nx_ = shift2d(px, dy, dx)
        ny_ = shift2d(py, dy, dx)
        nvalid = nd > 0
        dist_sq = (nx_ - px) ** 2 + (ny_ - py) ** 2 + (nd - pz) ** 2
        min_dist_sq = torch.minimum(
            min_dist_sq, torch.where(nvalid, dist_sq, float("inf")))
        count = count + nvalid.to(torch.int32)
    valid = (depth > 0) & (count >= 4)
    radius2 = torch.where(valid, min_dist_sq, 0.0)
    out_depth = torch.where(valid, depth, 0.0)
    return out_depth, radius2


def compute_sobel_gradient_magnitude(intensity: torch.Tensor) -> torch.Tensor:
    """3x3 Sobel gradient magnitude of an intensity image, normalized to
    [0, 1] (max |g| for [0, 1] inputs is 4*sqrt(2))."""
    tl = shift2d(intensity, -1, -1)
    t = shift2d(intensity, -1, 0)
    tr = shift2d(intensity, -1, 1)
    l = shift2d(intensity, 0, -1)  # noqa: E741
    r = shift2d(intensity, 0, 1)
    bl = shift2d(intensity, 1, -1)
    b = shift2d(intensity, 1, 0)
    br = shift2d(intensity, 1, 1)
    gx = (tr + 2.0 * r + br) - (tl + 2.0 * l + bl)
    gy = (bl + 2.0 * b + br) - (tl + 2.0 * t + tr)
    # The JAX package computes the constant in f32.
    norm = float(np.float32(1.0) / (np.float32(4.0) * np.sqrt(np.float32(2.0))))
    return torch.sqrt(gx * gx + gy * gy) * norm


def preprocess_frame(
    cam: PinholeCamera,
    depth_metric: torch.Tensor,
    rgb: torch.Tensor,
    max_depth: float = 3.0,
    sigma_xy: float = 1.5,
    radius_factor: float = 2.0,
    sigma_inv_depth: float = 0.005,
    *,
    a: torch.Tensor,
    cfactor: torch.Tensor,
    cell_size: int = 4,
    raw_to_float_depth: Optional[float] = None,
) -> ProcessedFrame:
    """Full preprocessing of one frame: brightness, bilateral filter +
    depth cutoff, depth deformation, normals, radii and isolated-pixel
    removal.

    `depth_metric` is metric f32, or raw u16 depth (as an integer tensor)
    scaled by `raw_to_float_depth` when that is given; `rgb` is [H, W, 3]
    u8. `a` and `cfactor` are the depth-deformation parameters (see
    `apply_depth_deformation`).
    """
    if raw_to_float_depth is not None:
        depth_metric = depth_metric.to(torch.float32) * raw_to_float_depth
    intensity = compute_brightness(rgb)
    filtered = bilateral_filter_and_cutoff(
        depth_metric, max_depth, sigma_xy, radius_factor, sigma_inv_depth)
    calibrated = apply_depth_deformation(filtered, a, cfactor, cell_size)
    d1, nx, ny = compute_normals(cam, calibrated)
    d2, radius2 = compute_radii_and_remove_isolated(cam, d1)
    # Normals of pixels invalidated by the radius step are zeroed.
    keep = d2 > 0
    return ProcessedFrame(
        depth=d2,
        nx=torch.where(keep, nx, 0.0),
        ny=torch.where(keep, ny, 0.0),
        radius2=radius2,
        intensity=intensity,
        raw_depth=torch.where(keep, filtered, 0.0),
        rgb=(rgb if rgb.dtype == torch.uint8
             else torch.clamp(rgb + 0.5, 0, 255).to(torch.uint8)),
    )



class FramePyramidLevel(NamedTuple):
    depth: torch.Tensor      # [H, W] f32, 0 invalid
    nx: torch.Tensor         # [H, W]
    ny: torch.Tensor         # [H, W]
    intensity: torch.Tensor  # [H, W] in [0, 1]


def _blocks(img: torch.Tensor) -> torch.Tensor:
    """[H, W] -> [H/2, W/2, 4] of 2x2 blocks (order: TL, TR, BL, BR)."""
    h, w = img.shape
    b = img[: (h // 2) * 2, : (w // 2) * 2].reshape(h // 2, 2, w // 2, 2)
    return b.permute(0, 2, 1, 3).reshape(h // 2, w // 2, 4)


def _sum4(b4: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 block samples, left to right."""
    return ((b4[..., 0] + b4[..., 1]) + b4[..., 2]) + b4[..., 3]


def downsample_level(level: FramePyramidLevel) -> FramePyramidLevel:
    d4 = _blocks(level.depth)
    valid = d4 > 0
    count = valid.sum(dim=-1)
    depth_sum = _sum4(torch.where(valid, d4, 0.0))
    mean = depth_sum / torch.clamp_min(count, 1)
    dist = torch.where(valid, torch.abs(d4 - mean[..., None]), float("inf"))
    idx = torch.argmin(dist, dim=-1, keepdim=True)

    def select(img4):
        return torch.gather(img4, -1, idx)[..., 0]

    any_valid = count > 0
    depth = torch.where(any_valid, select(d4), 0.0)
    nx = torch.where(any_valid, select(_blocks(level.nx)), 0.0)
    ny = torch.where(any_valid, select(_blocks(level.ny)), 0.0)
    # Intensity: average of the 4 pixels, then re-quantize to the u8 grid.
    inten = _sum4(_blocks(level.intensity)) / 4.0
    inten = torch.floor(inten * 255.0 + 0.5) * (1.0 / 255.0)
    return FramePyramidLevel(depth, nx, ny, inten)


def build_pyramid(
    depth: torch.Tensor,
    nx: torch.Tensor,
    ny: torch.Tensor,
    intensity: torch.Tensor,
    num_scales: int,
    gradmag: bool = False,
) -> Tuple[FramePyramidLevel, ...]:
    """Finest-first tuple of `num_scales` levels.

    With `gradmag`, the full-resolution Sobel gradient magnitude replaces
    the intensity plane before pyramid construction, so coarser levels are
    downsampled gradmag."""
    if gradmag:
        intensity = compute_sobel_gradient_magnitude(intensity)
    levels: List[FramePyramidLevel] = [FramePyramidLevel(depth, nx, ny, intensity)]
    for _ in range(num_scales - 1):
        levels.append(downsample_level(levels[-1]))
    return tuple(levels)



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


gather_nearest = gather_nearest_plain


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

