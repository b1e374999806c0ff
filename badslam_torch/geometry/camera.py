"""Pinhole camera model with the pixel-corner / pixel-center conventions.

Counterpart of ``badslam_tpu/geometry/camera.py``: the pinhole model SLAM
runs on, and the radial-tangential and thin-prism fisheye models that
describe distorted source images (host numpy, for the loader's undistortion
map):

  * Parameters (fx, fy, cx, cy) use the **pixel-corner** origin convention:
    pixel (x, y) covers the unit square [x, x+1) x [y, y+1), its center
    being (x + 0.5, y + 0.5).
  * Unprojection of integer pixel indices uses the pixel **center**:
    nx(px) = (px + 0.5 - cx) / fx.

The intrinsics are host floats. Self-calibration (``ba/intrinsics_opt.py``,
``ba/pcg.py``) replaces the camera with ``with_intrinsics`` after each of
its steps, reading its few updated values back from the device once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    fx: float
    fy: float
    cx: float  # pixel-corner convention
    cy: float
    width: int
    height: int

    def scaled(self, factor: float) -> "PinholeCamera":
        """Camera for an image scaled by `factor`."""
        return PinholeCamera(
            fx=self.fx * factor,
            fy=self.fy * factor,
            cx=self.cx * factor,
            cy=self.cy * factor,
            width=int(round(self.width * factor)),
            height=int(round(self.height * factor)),
        )

    def resized(self, width: int, height: int) -> "PinholeCamera":
        """Camera for the image resized to `width` x `height`, each axis by
        its own factor: fx and cx by width / self.width, fy and cy by
        height / self.height (pixel-corner coordinates scale with the
        image)."""
        sx, sy = width / self.width, height / self.height
        return PinholeCamera(fx=self.fx * sx, fy=self.fy * sy, cx=self.cx * sx,
                             cy=self.cy * sy, width=width, height=height)

    def pyramid_level(self, level: int) -> "PinholeCamera":
        cam = self
        for _ in range(level):
            cam = PinholeCamera(
                fx=cam.fx * 0.5, fy=cam.fy * 0.5, cx=cam.cx * 0.5, cy=cam.cy * 0.5,
                width=cam.width // 2, height=cam.height // 2,
            )
        return cam

    # -- center-convention unprojection helpers (for integer pixel indices) --

    @property
    def fx_inv(self) -> float:
        return 1.0 / self.fx

    @property
    def fy_inv(self) -> float:
        return 1.0 / self.fy

    @property
    def cx_inv(self) -> float:
        # = -(cx_center)/fx with cx_center = cx - 0.5
        return -(self.cx - 0.5) / self.fx

    @property
    def cy_inv(self) -> float:
        return -(self.cy - 0.5) / self.fy

    def with_intrinsics(self, fx, fy, cx, cy) -> "PinholeCamera":
        return PinholeCamera(fx=float(fx), fy=float(fy), cx=float(cx),
                             cy=float(cy), width=self.width, height=self.height)


# -- distorted source models (host numpy, float64 where the JAX package is) --
#
# SLAM runs on undistorted pinhole images. These models describe the SOURCE
# images of a distorted dataset so that the loader can decide the pinhole
# camera covering their field of view and build the [H, W, 2] remap table
# that preprocessing applies on the device (undistortion.h:40-58).


@dataclasses.dataclass(frozen=True)
class RadTanCamera:
    """Pinhole + radial-tangential (Brown) distortion (k1, k2, p1, p2)."""

    pinhole: PinholeCamera
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @property
    def width(self) -> int:
        return self.pinhole.width

    @property
    def height(self) -> int:
        return self.pinhole.height

    def radial_and_tangential(self, nx, ny):
        """The model's terms at normalized coords: (radial factor,
        tangential x, tangential y). Arithmetic only, so it runs on numpy
        arrays and on tensors alike."""
        r2 = nx * nx + ny * ny
        radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        dx = 2.0 * self.p1 * nx * ny + self.p2 * (r2 + 2.0 * nx * nx)
        dy = self.p1 * (r2 + 2.0 * ny * ny) + 2.0 * self.p2 * nx * ny
        return radial, dx, dy

    def distort_normalized(self, nx, ny):
        """Normalized coords -> distorted normalized coords."""
        radial, dx, dy = self.radial_and_tangential(nx, ny)
        return nx * radial + dx, ny * radial + dy

    def project_normalized(self, nx, ny):
        """Normalized coords -> distorted pixel-corner coordinates (numpy
        arrays or tensors)."""
        xd, yd = self.distort_normalized(nx, ny)
        c = self.pinhole
        return c.fx * xd + c.cx, c.fy * yd + c.cy

    def undistortion_map(self, target: Optional[PinholeCamera] = None) -> np.ndarray:
        """[H, W, 2] f32 source-pixel lookup for each pixel of `target`
        (default: the distortion-free pinhole core)."""
        return _undistortion_map(self, target or self.pinhole)


@dataclasses.dataclass(frozen=True)
class ThinPrismFisheyeCamera:
    """Pinhole + equidistant fisheye + radial (k1..k4) + tangential (p1, p2)
    + thin-prism (sx1, sy1) distortion, the 12-parameter model
    (camera.h:726-900)."""

    pinhole: PinholeCamera
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    sx1: float = 0.0
    sy1: float = 0.0

    @property
    def width(self) -> int:
        return self.pinhole.width

    @property
    def height(self) -> int:
        return self.pinhole.height

    def distort_normalized(self, nx, ny):
        """Undistorted normalized coords -> distorted normalized coords
        (fisheye theta/r scaling, then the polynomial inner part). The
        equidistant mapping applies even with all coefficients zero."""
        r = np.sqrt(nx * nx + ny * ny)
        theta_by_r = np.where(r > 1e-6, np.arctan(r) / np.maximum(r, 1e-12), 1.0)
        fx_ = theta_by_r * nx
        fy_ = theta_by_r * ny
        x2, y2, xy = fx_ * fx_, fy_ * fy_, fx_ * fy_
        r2 = x2 + y2
        r4 = r2 * r2
        radial = (self.k1 * r2 + self.k2 * r4 + self.k3 * r4 * r2
                  + self.k4 * r4 * r4)
        dx = 2.0 * self.p1 * xy + self.p2 * (r2 + 2.0 * x2) + self.sx1 * r2
        dy = 2.0 * self.p2 * xy + self.p1 * (r2 + 2.0 * y2) + self.sy1 * r2
        return fx_ + radial * fx_ + dx, fy_ + radial * fy_ + dy

    def project_normalized(self, nx, ny):
        """Undistorted normalized coords -> distorted pixel-corner coords."""
        xd, yd = self.distort_normalized(nx, ny)
        c = self.pinhole
        return c.fx * xd + c.cx, c.fy * yd + c.cy

    def undistortion_map(self, target: Optional[PinholeCamera] = None) -> np.ndarray:
        """[H, W, 2] f32 source-pixel lookup per target pixel."""
        return _undistortion_map(self, target or self.pinhole)


def _undistortion_map(model, target: PinholeCamera) -> np.ndarray:
    """Each target pixel center, unprojected with the target pinhole and
    projected through the distorted source model, in float32."""
    ys, xs = np.mgrid[0:target.height, 0:target.width].astype(np.float32)
    nx = (xs + 0.5 - target.cx) / target.fx
    ny = (ys + 0.5 - target.cy) / target.fy
    px, py = model.project_normalized(nx, ny)
    return np.stack([px, py], axis=-1).astype(np.float32)


def _unproject_normalized(model, px, py, iterations: int = 100):
    """Distorted pixel coords -> undistorted normalized coords by damped
    fixed-point inversion of `distort_normalized`, in float64."""
    c = model.pinhole
    xd = (np.asarray(px, np.float64) - c.cx) / c.fx
    yd = (np.asarray(py, np.float64) - c.cy) / c.fy
    nx, ny = xd.copy(), yd.copy()
    for _ in range(iterations):
        gx, gy = model.distort_normalized(nx, ny)
        ex, ey = gx - xd, gy - yd
        nx = nx - 0.7 * ex
        ny = ny - 0.7 * ey
        if max(np.max(np.abs(ex)), np.max(np.abs(ey))) < 1e-10:
            break
    return nx, ny


def decide_undistorted_camera(model, avoid_invalid_pixels: bool = False) -> PinholeCamera:
    """The pinhole camera covering a distorted model's field of view
    (DecideForUndistortedCamera, undistortion.cc:33-130): the source image's
    borders are unprojected and the pinhole spans their extent (with
    `avoid_invalid_pixels`, only the region where every pixel maps inside
    the source). The size truncates with int()."""
    c = model.pinhole
    w, h = model.width, model.height
    xs = np.arange(w, dtype=np.float64) + 0.5
    ys = np.arange(h, dtype=np.float64) + 0.5
    top_x, top_y = _unproject_normalized(model, xs, np.full(w, 0.5))
    bot_x, bot_y = _unproject_normalized(model, xs, np.full(w, h - 0.5))
    lef_x, lef_y = _unproject_normalized(model, np.full(h, 0.5), ys)
    rig_x, rig_y = _unproject_normalized(model, np.full(h, w - 0.5), ys)

    def px(nx):
        return c.fx * nx + c.cx

    def py(ny):
        return c.fy * ny + c.cy

    if avoid_invalid_pixels:
        min_x = np.max(px(lef_x))
        max_x = np.min(px(rig_x))
        min_y = np.max(py(top_y))
        max_y = np.min(py(bot_y))
    else:
        all_x = np.concatenate([top_x, bot_x, lef_x, rig_x])
        all_y = np.concatenate([top_y, bot_y, lef_y, rig_y])
        min_x, max_x = np.min(px(all_x)), np.max(px(all_x))
        min_y, max_y = np.min(py(all_y)), np.max(py(all_y))

    return PinholeCamera(
        fx=c.fx, fy=c.fy,
        cx=c.cx - float(min_x), cy=c.cy - float(min_y),
        width=max(1, int(max_x - min_x)), height=max(1, int(max_y - min_y)))
