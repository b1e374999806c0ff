"""Per-frame RGB-D preprocessing (PyTorch).

Counterpart of ``badslam_tpu/ops/preprocess.py``. All stages are
elementwise / small-stencil maps over ``[H, W]`` planes on the device of
their input. Invalid pixels are depth == 0.

Conventions:
  * depth planes are f32 metric meters, 0 = invalid.
  * intensity planes are f32 in [0, 1] on the u8-quantized grid.
  * normals are stored as (nx, ny) planes; nz = -sqrt(max(0, 1-nx^2-ny^2)).

The bilateral filter has two versions: ``bilateral_filter_and_cutoff`` here
is the plain PyTorch one; ``ops.kernels.bilateral_filter`` dispatches a CPU
tensor to it and a CUDA tensor to the hand-written CUDA kernel.
``preprocess_frame`` always goes through the dispatch.

The input stages before it (undistortion, the median filter, the input
pyramid's 2x2 downscales) are plain PyTorch, as they are XLA code in the
JAX package; the undistortion's image reads go through ``ops.interp``, so
on a CUDA tensor they launch the gather kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from badslam_torch.geometry.camera import PinholeCamera, RadTanCamera
from badslam_torch.ops import interp, kernels


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
    undistort_map: Optional[torch.Tensor] = None,
    median_iterations: int = 0,
) -> ProcessedFrame:
    """Full preprocessing of one frame: undistortion, median filter and
    densification, brightness, bilateral filter + depth cutoff, depth
    deformation, normals, radii and isolated-pixel removal.

    `depth_metric` is metric f32, or raw u16 depth (as an integer tensor)
    scaled by `raw_to_float_depth` when that is given; `rgb` is [H, W, 3]
    u8. With `undistort_map` ([H, W, 2] source-pixel lookup of a distorted
    camera) the frame is first remapped to the pinhole model: nearest for
    depth, bilinear for color (UndistortImage, undistortion.h:40-58); the
    color then goes back to u8 as clip(rgb + 0.5). `median_iterations`
    passes of `median_filter_and_densify` follow. `a` and `cfactor` are the
    depth-deformation parameters (see `apply_depth_deformation`). The
    bilateral filter runs through ``kernels.bilateral_filter``: the CUDA
    kernel on a CUDA tensor.
    """
    if raw_to_float_depth is not None:
        depth_metric = depth_metric.to(torch.float32) * raw_to_float_depth
    if undistort_map is not None:
        depth_metric = undistort_image(depth_metric, undistort_map, nearest=True)
        rgb = undistort_image(rgb.to(torch.float32), undistort_map)
    for _ in range(median_iterations):
        depth_metric = median_filter_and_densify(depth_metric)
    intensity = compute_brightness(rgb)
    filtered = kernels.bilateral_filter(
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


def median_filter_and_densify(depth: torch.Tensor) -> torch.Tensor:
    """3x3 median filter + densification on depth (0 = invalid)
    (MedianFilterAndDensifyDepthMap, preprocessing.cc:40-86): a pixel with
    >= 2 valid values in its 3x3 neighborhood gets their median (an even
    count picks the middle element closer to their mean); others pass
    through. The mean sums the 9 slots left to right, the JAX package's
    order, so that ties between the two middles break the same way."""
    big = 3.4e38
    valid, slots = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            v = shift2d(depth, dy, dx)
            valid.append(v > 0)
            slots.append(v)
    total = torch.where(valid[0], slots[0], 0.0)
    for v, s in zip(valid[1:], slots[1:]):
        total = total + torch.where(v, s, 0.0)
    count = torch.stack(valid, dim=-1).sum(dim=-1)
    ordered = torch.sort(torch.stack(
        [torch.where(v, s, big) for v, s in zip(valid, slots)], dim=-1), dim=-1).values
    mid_hi = count // 2
    mid_lo = torch.clamp_min(mid_hi - 1, 0)
    hi = torch.gather(ordered, -1, mid_hi[..., None])[..., 0]
    lo = torch.gather(ordered, -1, mid_lo[..., None])[..., 0]
    mean = total / torch.clamp_min(count, 1).to(torch.float32)
    even = (count % 2) == 0
    median = torch.where(even & (torch.abs(lo - mean) < torch.abs(hi - mean)), lo, hi)
    return torch.where(count >= 2, median, depth)


def _blocks_2x2(img: torch.Tensor) -> torch.Tensor:
    """[H, W, ...] -> [H // 2, W // 2, 4, ...]: each 2x2 block's samples in
    row-major order (an odd last row or column is dropped)."""
    h, w = img.shape[0] // 2, img.shape[1] // 2
    rest = img.shape[2:]
    return (img[: 2 * h, : 2 * w].reshape(h, 2, w, 2, *rest)
            .transpose(1, 2).reshape(h, w, 4, *rest))


def downscale_depth_median(depth: torch.Tensor) -> torch.Tensor:
    """Half-resolution depth: the median of the valid (non-zero) samples of
    each 2x2 block, the lower middle for an even count (a measured sample,
    never an average across a depth edge); 0 where none is valid
    (DownscaleUsingMedianWhileExcluding(0), bad_slam.cc:668-677)."""
    d4 = _blocks_2x2(depth)
    valid = d4 > 0
    count = valid.sum(dim=-1)
    ordered = torch.sort(torch.where(valid, d4, float("inf")), dim=-1).values
    mid = torch.clamp_min((count + 1) // 2 - 1, 0)
    med = torch.gather(ordered, -1, mid[..., None])[..., 0]
    return torch.where(count > 0, med, 0.0)


def downscale_color(rgb: torch.Tensor) -> torch.Tensor:
    """Half-resolution color: the 2x2 average, rounded for u8 input
    (bad_slam.cc:680-688)."""
    out = _blocks_2x2(rgb).to(torch.float32).mean(dim=2) + 0.5
    return out.to(rgb.dtype) if rgb.dtype == torch.uint8 else (out - 0.5).to(rgb.dtype)


def create_undistortion_map(distort_fn, undistorted_cam: PinholeCamera,
                            height: int, width: int,
                            device: torch.device | str = "cuda") -> torch.Tensor:
    """[H, W, 2] map on `device`: for each undistorted pixel center, the
    source pixel coordinates in the distorted image (CreateUndistortionMap,
    undistortion.h:40-58). `distort_fn(nx, ny) -> (px, py)` projects
    normalized coords to the source camera's pixel-corner coords, e.g. a
    model's `project_normalized`. The loader builds its map on the host
    instead (`RadTanCamera.undistortion_map`), as the JAX loader does: the
    two evaluate the pixel centers in other float32 orders and agree to a
    few ulp."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    like = torch.empty((), dtype=torch.float32, device=device)
    ys, xs = _pixel_grid(height, width, like)
    nx = undistorted_cam.fx_inv * xs + undistorted_cam.cx_inv
    ny = undistorted_cam.fy_inv * ys + undistorted_cam.cy_inv
    px, py = distort_fn(nx, ny)
    return torch.stack([px, py], dim=-1)


def undistort_image(image: torch.Tensor, undistortion_map: torch.Tensor,
                    nearest: bool = False) -> torch.Tensor:
    """Remap an [H, W] or [H, W, C] image through an undistortion map
    (UndistortImage): bilinear, or nearest (`nearest=True`, for depth);
    0 where the map points outside the source image. The reads go through
    ``interp.gather_nearest`` (one batched gather per tap for all channels)."""
    h, w = image.shape[:2]
    px = undistortion_map[..., 0]
    py = undistortion_map[..., 1]
    inside = (px >= 0) & (py >= 0) & (px < w) & (py < h)
    planes = image if image.ndim == 2 else image.permute(2, 0, 1)
    if image.ndim == 3:
        shape = (image.shape[2],) + px.shape
        px, py = px.expand(shape), py.expand(shape)
    if nearest:
        xi = torch.clamp(torch.floor(px).to(torch.int64), 0, w - 1)
        yi = torch.clamp(torch.floor(py).to(torch.int64), 0, h - 1)
        out = interp.gather_nearest(planes.to(torch.float32), xi, yi).to(image.dtype)
    else:
        out = interp.bilinear(planes, px, py)
    if image.ndim == 3:
        out = out.permute(1, 2, 0)
        inside = inside[..., None]
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype, device=out.device))


def radtan_distort_fn(cam: PinholeCamera, k1: float, k2: float,
                      p1: float = 0.0, p2: float = 0.0):
    """Radial-tangential (Brown) projection of normalized coords to pixel
    coords, for `create_undistortion_map`: `RadTanCamera`'s own model."""
    return RadTanCamera(cam, k1, k2, p1, p2).project_normalized
