"""The port end to end: badslam_torch.cli against badslam_tpu.cli on one
synthetic sequence, odometry alone and with keyframe bundle adjustment,
plus the port's PNG IO and numpy renderer against what the JAX package
reads and renders.

Tolerances:
  * trajectories: t atol 1e-4 m, q atol 1e-4, per frame. Both CLIs run the
    same odometry and BA in float32; the residual sums are taken in another
    order, which moves each Gauss-Newton minimum by far less than that
    (measured after BA: 1.4e-6 m, 6.3e-7 in q).
  * ATE of both against ground truth: below 1e-3 m (tests/test_e2e.py's
    bound for the full system).
  * exported point clouds: point counts within 1% (surfel creation and
    deletion are threshold tests on float values).
  * PNG decoding and the renderer: exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from badslam_tpu import synthetic as jsyn
from badslam_tpu.cli import main as jax_main
from badslam_tpu.io import dataset as jds
from badslam_torch import synthetic as tsyn
from badslam_torch.cli import main as torch_main
from badslam_torch.frontend import BadSlam
from badslam_torch.io import dataset as tds
from badslam_torch.io import png

torch.set_num_threads(1)

# 13 frames at keyframe_interval 6: keyframes at 0, 6 and 12, so the JAX
# CLI compiles one chunk and one steady-frame program, not two of the latter.
FRAMES = 13
FLAGS = ["--num_scales", "4", "--keyframe_interval", "6",
         "--max_num_ba_iterations_per_keyframe", "0",
         "--enable_loop_detection", "false", "--fps_restriction", "0",
         "--max_surfel_count", str(1 << 14), "--quiet"]
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "tum_fixture")


def _trajectory(path):
    _, poses = tds.load_tum_trajectory(path)
    return (np.stack([p.q for p in poses]).astype(np.float64),
            np.stack([p.t for p in poses]).astype(np.float64), poses)


def test_cli_trajectory_matches_jax_cli(tmp_path):
    data = str(tmp_path / "seq")
    cam = tsyn.default_camera(160, 120)
    scene = tsyn.random_plane_scene(np.random.default_rng(5), 6)
    gt = tsyn.smooth_trajectory(FRAMES)
    tsyn.write_tum_dataset(data, cam, scene, gt)

    jax_out, torch_out = str(tmp_path / "jax.txt"), str(tmp_path / "torch.txt")
    assert jax_main([data, *FLAGS, "--export_poses", jax_out]) == 0
    assert torch_main([data, "--device", "cpu", *FLAGS,
                       "--export_poses", torch_out]) == 0

    qj, tj, pj = _trajectory(jax_out)
    qt, tt, pt = _trajectory(torch_out)
    assert len(pt) == len(pj) == FRAMES
    np.testing.assert_allclose(tt, tj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(qt, qj, atol=1e-4, rtol=0)
    assert tsyn.ate_rmse(pt, gt) < 1e-3
    assert tsyn.ate_rmse(pj, gt) < 1e-3
    assert abs(tsyn.ate_rmse(pt, gt) - jsyn.ate_rmse(pt, gt)) < 1e-12


BA_FLAGS = ["--num_scales", "4", "--keyframe_interval", "6",
            "--max_num_ba_iterations_per_keyframe", "4",
            "--enable_loop_detection", "false", "--fps_restriction", "0",
            "--max_surfel_count", str(1 << 14), "--quiet"]


@pytest.mark.parametrize("extra", [
    [],
    ["--keyframe_interval", "2", "--max_keyframe_count", "5"],
], ids=["interval6", "keyframe_budget"])
def test_ba_cli_matches_jax_cli(tmp_path, extra):
    """The default main path with loop detection off: keyframes every 6
    frames, parallel BA (two iterations at a keyframe, the rest drained
    two per frame), trajectory deformation and the point-cloud export.
    `keyframe_budget`: a keyframe every 2 frames against a budget of 5, so
    the guard merges redundant keyframes and the deformation brackets
    frames by the live keyframes only."""
    from badslam_tpu.io.ply import load_ply

    data = str(tmp_path / "seq")
    cam = tsyn.default_camera(160, 120)
    scene = tsyn.random_plane_scene(np.random.default_rng(5), 6)
    gt = tsyn.smooth_trajectory(FRAMES)
    tsyn.write_tum_dataset(data, cam, scene, gt)

    out = {k: (str(tmp_path / f"{k}.txt"), str(tmp_path / f"{k}.ply"))
           for k in ("jax", "torch")}
    times = str(tmp_path / "times.json")
    assert jax_main([data, *BA_FLAGS, *extra, "--export_poses", out["jax"][0],
                     "--export_point_cloud", out["jax"][1]]) == 0
    assert torch_main([data, "--device", "cpu", *BA_FLAGS, *extra,
                       "--export_poses", out["torch"][0],
                       "--export_point_cloud", out["torch"][1],
                       "--export_frame_times", times]) == 0
    with open(times) as f:
        summary = json.load(f)
    if extra:
        assert summary["keyframes"] < len(summary["keyframe_frames"]) == 7

    qj, tj, pj = _trajectory(out["jax"][0])
    qt, tt, pt = _trajectory(out["torch"][0])
    assert len(pt) == len(pj) == FRAMES
    np.testing.assert_allclose(tt, tj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(qt, qj, atol=1e-4, rtol=0)
    assert tsyn.ate_rmse(pt, gt) < 1e-3
    assert tsyn.ate_rmse(pj, gt) < 1e-3
    nj, nt = len(load_ply(out["jax"][1])), len(load_ply(out["torch"][1]))
    assert nj > 500 and abs(nt - nj) <= 0.01 * nj, (nt, nj)


def test_motion_model_matches_jax():
    from badslam_tpu.frontend import _predict_pose
    from badslam_torch.frontend import predict_pose

    rng = np.random.default_rng(12)
    q = rng.normal(size=(3, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(scale=0.05, size=(3, 3)).astype(np.float32)
    for n in (1, 2, 3):
        jq1, jt1, jq2, jt2 = _predict_pose(q, t, n)
        e1, e2 = predict_pose(torch.from_numpy(q), torch.from_numpy(t), n)
        for a, b in ((e1.q, jq1), (e1.t, jt1), (e2.q, jq2), (e2.t, jt2)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_trajectory_interpolation_matches_jax(tmp_path):
    data = str(tmp_path / "seq")
    cam = tsyn.default_camera(32, 24)
    scene = tsyn.random_plane_scene(np.random.default_rng(1), 2)
    tsyn.write_tum_dataset(data, cam, scene, tsyn.smooth_trajectory(4), write_gt=False)
    # A trajectory sampled between and beyond the frames, written out of order.
    lines = []
    for k, pose in enumerate(tsyn.smooth_trajectory(12, scale=0.03)):
        q, t = pose.q, pose.t
        lines.append(f"{k / 70.0 - 0.01:.6f} {t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]}")
    with open(os.path.join(data, "traj.txt"), "w") as f:
        f.write("\n".join(lines[::-1]) + "\n")
    jv = jds.load_tum_dataset(data, "traj.txt")
    tv = tds.load_tum_dataset(data, "traj.txt")
    assert tv.timestamps == jv.timestamps
    for pt, pj in zip(tv.poses, jv.poses):
        np.testing.assert_allclose(pt.q, np.asarray(pj.q), atol=1e-7, rtol=0)
        np.testing.assert_allclose(pt.t, np.asarray(pj.t), atol=1e-7, rtol=0)


def test_profile_writes_spans_and_counts(tmp_path):
    data = str(tmp_path / "seq")
    cam = tsyn.default_camera(64, 48)
    scene = tsyn.random_plane_scene(np.random.default_rng(4), 4)
    tsyn.write_tum_dataset(data, cam, scene, tsyn.smooth_trajectory(3))
    out = str(tmp_path / "prof")
    assert torch_main([data, "--device", "cpu", "--num_scales", "2",
                       "--max_num_ba_iterations_per_keyframe", "0",
                       "--enable_loop_detection", "false", "--fps_restriction", "0",
                       "--quiet", "--profile", out]) == 0
    with open(os.path.join(out, "profile_summary.json")) as f:
        summary = json.load(f)
    assert summary["frames"] == 3
    spans = summary["spans"]
    assert spans["preprocess"]["count"] == spans["pyramid"]["count"] == 3
    assert spans["track"]["count"] == 2
    assert sum(v["count"] for k, v in spans.items() if k.startswith("gn_iteration/")) >= 2
    assert os.path.getsize(os.path.join(out, "key_averages.txt")) > 0


def test_first_frame_takes_the_dataset_prior(tmp_path):
    data = str(tmp_path / "seq")
    cam = tsyn.default_camera(64, 48)
    scene = tsyn.random_plane_scene(np.random.default_rng(2), 3)
    gt = [tsyn.pose(tx=0.1, ty=-0.2, rz=0.05), tsyn.pose(tx=0.11, ty=-0.2, rz=0.05)]
    tsyn.write_tum_dataset(data, cam, scene, gt)
    from badslam_tpu.config import BadSlamConfig

    cfg = BadSlamConfig(num_scales=2, max_num_ba_iterations_per_keyframe=0,
                        enable_loop_detection=False, fps_restriction=0)
    video = tds.load_tum_dataset(data, "groundtruth.txt")
    slam = BadSlam(cfg, video, "cpu")
    slam.process_frame(0)
    np.testing.assert_allclose(slam.traj_t[0].numpy(), gt[0].t, atol=1e-6)
    np.testing.assert_allclose(slam.traj_q[0].numpy(), gt[0].q, atol=1e-6)


@pytest.mark.parametrize("argv, what", [
    (["--n_devices", "2"], "multi-device slice"),
    (["--pyramid_level_for_depth", "1"], "must equal pyramid_level_for_color"),
    (["--pyramid_level_for_depth", "1", "--pyramid_level_for_color", "1",
      "--median_filter_and_densify_iterations", "1"], "median filter"),
    (["--export_point_cloud", "x.ply", "--export_viewer", "v"], "map viewer"),
    (["--save_timings", "t.txt"], "timing rows"),
    (["--live_viewer_dir", "v"], "map viewer"),
    (["--live", "dir:x"], "live input"),
    (["--autotune"], "tuned variants"),
], ids=["n_devices", "pyramid_level", "median", "point_cloud", "save_timings",
        "live_viewer", "live", "autotune"])
def test_later_slices_are_refused(tmp_path, argv, what):
    """What the port still refuses, before it reads the dataset: the later
    slices' settings and flags, and the JAX package's own refusals of the
    input pyramid (unequal levels; a level with the median filter)."""
    base = ["--max_num_ba_iterations_per_keyframe", "0",
            "--enable_loop_detection", "false"]
    with pytest.raises(NotImplementedError, match=what):
        torch_main([str(tmp_path), "--device", "cpu", *base, *argv])


def test_calibration_lines_load_like_jax(tmp_path):
    """Every form of the calibration grammar gives JAX's camera (and, for a
    distorted source, its undistortion map); an unknown model name raises
    ValueError in both loaders. One difference: a radial-tangential line
    whose terms are all zero is a pinhole for the port, while the JAX
    loader's model dispatch falls through and calls it unknown."""
    data = str(tmp_path / "seq")
    cam = tsyn.default_camera(32, 24)
    tsyn.write_tum_dataset(data, cam, tsyn.random_plane_scene(np.random.default_rng(0), 2),
                           [tsyn.pose()], write_gt=False)
    base = f"{cam.fx} {cam.fy} {cam.cx} {cam.cy}"
    for line in (base + " 0 0 0 0", "radtan " + base + " 0 0"):
        with open(os.path.join(data, "calibration.txt"), "w") as f:
            f.write(line + "\n")
        assert tds.load_tum_dataset(data).camera == cam
        assert tds.load_tum_dataset(data).undistortion_map is None
        with pytest.raises(ValueError, match="unknown camera model 'radtan'"):
            jds.load_tum_dataset(data)
    lines = (base, "pinhole " + base, base + " 0.1 0",
             base + " -0.05 0.01 0.001 0.002", "radtan " + base + " -0.05 0.01",
             base + " 0 0 0 0 0 0 0 0", base + " 0.01 -0.002 0 0 0.001 0 0 0",
             "thin_prism_fisheye " + base + " 0.01 0 0 0 0 0 0.001 0",
             "fisheye " + base + " 0 0 0 0 0 0 0 0")
    for line in lines:
        with open(os.path.join(data, "calibration.txt"), "w") as f:
            f.write(line + "\n")
        tv, jv = tds.load_tum_dataset(data), jds.load_tum_dataset(data)
        assert (tv.camera.fx, tv.camera.fy, tv.camera.cx, tv.camera.cy, tv.camera.width,
                tv.camera.height) == (jv.camera.fx, jv.camera.fy, jv.camera.cx, jv.camera.cy,
                                      jv.camera.width, jv.camera.height), line
        assert (tv.undistortion_map is None) == (jv.undistortion_map is None), line
        if tv.undistortion_map is not None:
            np.testing.assert_allclose(tv.undistortion_map, jv.undistortion_map,
                                       atol=1e-5, rtol=0, err_msg=line)
        else:
            assert tv.camera == cam, line
    for line in ("kannala " + base + " 0.1 0", base + " 0.1 0 0"):
        with open(os.path.join(data, "calibration.txt"), "w") as f:
            f.write(line + "\n")
        with pytest.raises(ValueError):
            tds.load_tum_dataset(data)
        with pytest.raises(ValueError):
            jds.load_tum_dataset(data)


def test_cuda_device_without_cuda_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main([str(tmp_path), "--device", "cuda",
                    "--max_num_ba_iterations_per_keyframe", "0",
                    "--enable_loop_detection", "false"])


def test_png_reader_decodes_the_tum_fixture():
    files = sorted(os.listdir(os.path.join(FIXTURE, "rgb")))
    depth_files = sorted(os.listdir(os.path.join(FIXTURE, "depth")))
    assert files and depth_files
    for name in files:
        path = os.path.join(FIXTURE, "rgb", name)
        np.testing.assert_array_equal(tds._imread_color(path), jds._imread_color(path))
    for name in depth_files:
        path = os.path.join(FIXTURE, "depth", name)
        np.testing.assert_array_equal(tds._imread_depth(path), jds._imread_depth(path))


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
              rng.integers(0, 65536, (37, 53), dtype=np.uint16),
              rng.integers(0, 256, (5, 7), dtype=np.uint8)]
    for i, img in enumerate(images):
        path = str(tmp_path / f"{i}.png")
        png.write_png(path, img)
        out = png.read_png(path)
        assert out.dtype == img.dtype
        np.testing.assert_array_equal(out, img)
    # The written files are standard PNGs: the JAX package's loader reads them.
    np.testing.assert_array_equal(jds._imread_depth(str(tmp_path / "1.png")), images[1])
    np.testing.assert_array_equal(jds._imread_color(str(tmp_path / "0.png")), images[0])


@pytest.mark.parametrize("bit_depth, color_type, channels", [
    (8, 0, 1), (16, 0, 1), (8, 2, 3), (8, 4, 2), (8, 6, 4), (16, 2, 3)],
    ids=["gray8", "gray16", "rgb8", "gray_alpha8", "rgba8", "rgb16"])
def test_png_row_filters(tmp_path, bit_depth, color_type, channels):
    """Every row filter decodes, for every color type the reader takes: rows
    filtered with None, Sub, Up, Average and Paeth by a reference encoder
    written here from the PNG specification."""
    import struct
    import zlib

    rng = np.random.default_rng(10)
    dtype = np.uint16 if bit_depth == 16 else np.uint8
    img = rng.integers(0, np.iinfo(dtype).max + 1, (6, 9, channels), dtype=dtype)
    raw = img.astype(">u2" if bit_depth == 16 else np.uint8).view(np.uint8)
    raw = raw.reshape(6, -1).astype(np.int64)
    bpp = channels * bit_depth // 8
    out_rows = []
    for y in range(6):
        kind = y % 5
        prior = raw[y - 1] if y else np.zeros_like(raw[0])
        row = raw[y]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out_rows.append(bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 9, 6, bit_depth, color_type, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out_rows)))
            + chunk(b"IEND", b""))
    expected = img[..., 0] if channels == 1 else img
    decoded = png.decode_png(data)
    assert decoded.dtype == dtype
    np.testing.assert_array_equal(decoded, expected)
    # The dataset's color reader returns [H, W, 3] u8 for every layout.
    path = tmp_path / "x.png"
    path.write_bytes(data)
    color = tds._imread_color(str(path))
    assert color.shape == (6, 9, 3) and color.dtype == np.uint8


def test_renderer_matches_jax():
    cam_t = tsyn.default_camera(80, 60)
    cam_j = jsyn.default_camera(80, 60)
    scene_t = tsyn.random_plane_scene(np.random.default_rng(3), 5)
    scene_j = jsyn.random_plane_scene(np.random.default_rng(3), 5)
    for p_t, p_j in zip(tsyn.smooth_trajectory(3), jsyn.smooth_trajectory(3)):
        np.testing.assert_array_equal(p_t.q, p_j.q)
        dt, it = tsyn.render_scene(cam_t, scene_t, p_t)
        dj, ij = jsyn.render_scene(cam_j, scene_j, p_j)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(it, ij)
