"""The port at the ETH3D SLAM camera's ragged shape, on the CPU.

* The program's plain preprocessing, pyramid and tracker against the
  benchmark's frozen reference (``slam_bench/reference/``) at 73x45, the
  eth3d_739x458 intrinsics scaled by 73/739 (73 % 4 = 1 and 45 % 8 = 5, so
  the sparse-cell grid is ragged and every pyramid level drops a row or a
  column), under the corridor_walk mix: equal to the last bit, as
  slam_bench/tests/test_slam_bench_reference.py holds them at 64x48. (The
  JAX package holds the same three at this shape in
  tests/test_torch_preprocess.py and tests/test_torch_tracking.py.)
* The loop detector's camera for resized detection images: each axis
  scaled by its own factor. A depth pixel of the resized image
  back-projects, through that camera, onto the source pixel that
  ``resize_nearest`` took it from, within half a source pixel plus half a
  detection pixel (the nearest resize takes the source pixel under a
  detection pixel's top-left corner, not under its centre); the one-factor
  ``scaled`` camera misses by several pixels in y. A detection size equal
  to the camera's skips the resize.
"""

import json
import os

import numpy as np
import pytest
import torch

from badslam_torch.geometry.camera import PinholeCamera
from badslam_torch.loop.detector import LoopDetector
from badslam_torch.ops.preprocess import preprocess_frame
from badslam_torch.ops.pyramid import build_pyramid
from badslam_torch.tracking.pairwise import track_frame_pairwise

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_eth3d():
    with open(os.path.join(ROOT, "slam_bench", "tests", "data", "tiny_eth3d.json")) as f:
        return json.load(f)


def test_program_equals_the_reference_at_a_ragged_shape():
    from slam_bench import check, scene
    from slam_bench.reference import frame as rframe
    from slam_bench.reference import geometry as rse3

    cfg = _tiny_eth3d()
    c, s = cfg["camera"], cfg["settings"]
    assert (c["width"] % 4, c["height"] % 8) == (1, 5)
    seq = scene.render(c, scene.load_mix("corridor_walk"), 10, 30.0, 2**31 + 77,
                       cfg["raw_to_float_depth"], "cpu")
    cam = PinholeCamera(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], width=c["width"],
                        height=c["height"])
    cams = tuple(cam.pyramid_level(i) for i in range(s["num_scales"]))
    cell = s["sparse_surfel_cell_size"]
    a = torch.zeros(())
    cf = torch.zeros(((c["height"] - 1) // cell + 1, (c["width"] - 1) // cell + 1))
    ref = check.Reference(cfg, "cpu")

    def port(i):
        f = preprocess_frame(cam, torch.from_numpy(seq.depth_u16[i].astype(np.int32)),
                             torch.from_numpy(seq.color_u8[i]), max_depth=s["max_depth"],
                             a=a, cfactor=cf, cell_size=cell,
                             raw_to_float_depth=cfg["raw_to_float_depth"])
        return f, build_pyramid(f.depth, f.nx, f.ny, f.intensity, s["num_scales"])

    def reference(i):
        f = rframe.preprocess_frame(
            ref.cam, torch.from_numpy(seq.depth_u16[i].astype(np.int32)),
            torch.from_numpy(seq.color_u8[i]), max_depth=s["max_depth"],
            sigma_xy=s["bilateral_filter_sigma_xy"],
            radius_factor=s["bilateral_filter_radius_factor"],
            sigma_inv_depth=s["bilateral_filter_sigma_inv_depth"], a=ref.a,
            cfactor=ref.cfactor, cell_size=cell, raw_to_float_depth=cfg["raw_to_float_depth"])
        return f, ref.pyramid(seq.depth_u16[i], seq.color_u8[i])

    (fp, base_p), (fr, base_r) = port(0), reference(0)
    for name in ("depth", "nx", "ny", "radius2", "intensity"):
        assert torch.equal(getattr(fp, name), getattr(fr, name)), name
    assert bool((fp.depth > 0).any())
    assert [tuple(level.depth.shape) for level in base_p] == [(45, 73), (22, 36), (11, 18)]
    assert [(k.width, k.height) for k in cams] == [(73, 45), (36, 22), (18, 11)]
    for lp, lr in zip(base_p, base_r):
        for x, y in zip(lp, lr):
            assert torch.equal(x, y)
    ident = rse3.identity("cpu")
    for i in (1, 3, 5):  # tracked from the identity, as far as it holds here
        got = track_frame_pairwise(cams, base_p, port(i)[1], ident.q, ident.t, ident.q,
                                   ident.t)
        want = ref.track(base_r, reference(i)[1], ident, ident, False)
        assert torch.equal(got.q, want.q) and torch.equal(got.t, want.t)
        assert int(got.residual_count) > 1000


SOURCE = PinholeCamera(fx=72.63, fy=72.63, cx=35.51, cy=18.7, width=74, height=46)


def _source_depth():
    rng = np.random.default_rng(5)
    d = rng.uniform(0.5, 3.0, (SOURCE.height, SOURCE.width)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.1] = 0.0
    return d


def _pixel_gaps(det_cam, depth_small, w, h):
    """Per resized pixel with depth, how far (in source pixels, per axis)
    its point back-projected through `det_cam` projects into the source
    image from the centre of the source pixel resize_nearest took."""
    ys, xs = np.nonzero(depth_small > 0)
    d = depth_small[ys, xs].astype(np.float64)
    px = (xs + 0.5 - det_cam.cx) / det_cam.fx * d
    py = (ys + 0.5 - det_cam.cy) / det_cam.fy * d
    u = SOURCE.fx * px / d + SOURCE.cx
    v = SOURCE.fy * py / d + SOURCE.cy
    sx = np.floor(xs * (SOURCE.width / w)).astype(np.int64)
    sy = np.floor(ys * (SOURCE.height / h)).astype(np.int64)
    return np.abs(u - (sx + 0.5)), np.abs(v - (sy + 0.5)), sx, sy, ys, xs


def test_detection_camera_matches_its_resized_image_on_both_axes():
    w, h = 64, 48
    det = LoopDetector(cam=SOURCE, images_size=(w, h))
    depth = _source_depth()
    gray = (np.arange(SOURCE.width * SOURCE.height) % 251).astype(np.uint8).reshape(
        SOURCE.height, SOURCE.width)
    gray_small, depth_small, det_cam = det._detection_inputs(gray, depth)
    assert gray_small.shape == depth_small.shape == (h, w)
    assert (det_cam.width, det_cam.height) == (w, h)
    assert det_cam.fx == pytest.approx(SOURCE.fx * w / SOURCE.width)
    assert det_cam.fy == pytest.approx(SOURCE.fy * h / SOURCE.height)
    assert det_cam.cx == pytest.approx(SOURCE.cx * w / SOURCE.width)
    assert det_cam.cy == pytest.approx(SOURCE.cy * h / SOURCE.height)
    gx, gy, sx, sy, ys, xs = _pixel_gaps(det_cam, depth_small, w, h)
    assert len(gx) > 0.8 * w * h
    assert np.array_equal(depth_small[ys, xs], depth[sy, sx])  # the source pixel
    assert gx.max() < 0.5 * (1 + SOURCE.width / w) + 1e-9
    assert gy.max() < 0.5 * (1 + SOURCE.height / h) + 1e-9
    # The one-factor camera of the width's scale misplaces rows.
    one = SOURCE.scaled(w / SOURCE.width)
    assert one.height != h
    gx1, gy1 = _pixel_gaps(one, depth_small, w, h)[:2]
    assert gy1.max() > 5.0 and np.array_equal(gx1, gx)


def test_detection_at_the_cameras_size_skips_the_resize():
    cam = SOURCE.resized(64, 48)
    assert cam.resized(64, 48) == cam
    det = LoopDetector(cam=cam, images_size=(64, 48))
    assert det.images_size is None
    gray = np.zeros((48, 64), np.uint8)
    depth = np.ones((48, 64), np.float32)
    g, d, c = det._detection_inputs(gray, depth)
    assert g is gray and d is depth and c is cam
