"""The port's input stages against the JAX package: distorted cameras and
their undistortion, the median filter, the input pyramid's downscales, raw
TUM association, the distorted renderer and dataset writer, and the CLI on
distorted, raw and downscaled input.

Every case gives the same seeded numpy input to the JAX function and to
its port. Tolerances:
  * undistorted-camera decisions: exact (the same float64 numpy);
    undistortion maps within 1e-5 px;
  * undistort_image: nearest exact, bilinear within 1e-5 (u8 values);
  * median filter (1 and 2 passes, with holes), the 2x2 depth median and
    the 2x2 color average: exact;
  * association and the loaded fixture: equal pairs, paths, timestamps and
    camera, map within 1e-5;
  * render_scene_radtan: within 1e-6 (exact in practice);
  * one preprocessed frame with undistortion and the median filter: depth
    and radii within 1e-5, normals 1e-4 (they amplify depth differences);
  * CLI against CLI: poses within 1e-4 (t in metres, q), as in
    tests/test_torch_slice.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu import synthetic as jsyn
from badslam_tpu.cli import main as jax_main
from badslam_tpu.geometry import camera as jcam
from badslam_tpu.io import dataset as jds
from badslam_tpu.ops import preprocess as jpre
from badslam_torch import convert
from badslam_torch import synthetic as tsyn
from badslam_torch.cli import main as torch_main
from badslam_torch.geometry import camera as tcam
from badslam_torch.io import dataset as tds
from badslam_torch.ops import preprocess as tpre

torch.set_num_threads(1)

MAP_ATOL = 1e-5
POSE_ATOL = 1e-4
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "tum_fixture")
CLI_FLAGS = ["--enable_loop_detection", "false", "--fps_restriction", "0",
             "--max_surfel_count", str(1 << 14), "--quiet"]


def _pinholes(width, height, fx=None, cx=None, cy=None):
    fx = fx or 0.55 * width
    kw = dict(fx=fx, fy=fx, cx=width / 2.0 if cx is None else cx,
              cy=height / 2.0 if cy is None else cy, width=width, height=height)
    return jcam.PinholeCamera(**kw), tcam.PinholeCamera(**kw)


# (name, (w, h, fx, cx, cy), model, parameters, the decided size where known)
MODELS = {
    "radtan2": ((160, 120, None, None, None), "radtan", (-0.05, 0.01), None),
    "radtan4": ((160, 120, None, None, None), "radtan", (0.04, -0.02, 0.002, -0.001), None),
    "vga_radtan": ((640, 480, 525.0, 320.0, 240.0), "radtan", (-0.08, 0.01), (670, 502)),
    "prism_zero": ((64, 48, 60.0, 32.0, 24.0), "prism", (0.0,) * 8, (73, 55)),
    "prism": ((96, 72, None, None, None), "prism",
              (0.01, -0.005, 0.001, 0.0, 0.001, -0.0005, 0.0008, -0.0004), None),
    "fixture": ((64, 48, 60.0, 32.0, 24.0), "radtan", (0.05, -0.02, 0.001, -0.001), (62, 46)),
}


def _models(name):
    (w, h, fx, cx, cy), kind, params, size = MODELS[name]
    jp, tp = _pinholes(w, h, fx, cx, cy)
    if kind == "radtan":
        k = list(params) + [0.0] * (4 - len(params))
        names = ("k1", "k2", "p1", "p2")
        jm = jcam.RadTanCamera(pinhole=jp, **dict(zip(names, k)))
        tm = tcam.RadTanCamera(pinhole=tp, **dict(zip(names, k)))
    else:
        names = ("k1", "k2", "k3", "k4", "p1", "p2", "sx1", "sy1")
        jm = jcam.ThinPrismFisheyeCamera(pinhole=jp, **dict(zip(names, params)))
        tm = tcam.ThinPrismFisheyeCamera(pinhole=tp, **dict(zip(names, params)))
    return jm, tm, size


def _same_camera(t, j):
    assert (t.fx, t.fy, t.cx, t.cy, t.width, t.height) == (
        j.fx, j.fy, j.cx, j.cy, j.width, j.height)


@pytest.mark.parametrize("name", list(MODELS))
def test_undistorted_camera_and_map_match_jax(name):
    jm, tm, size = _models(name)
    jdec = jcam.decide_undistorted_camera(jm)
    tdec = tcam.decide_undistorted_camera(tm)
    _same_camera(tdec, jdec)
    _same_camera(tcam.decide_undistorted_camera(tm, avoid_invalid_pixels=True),
                 jcam.decide_undistorted_camera(jm, avoid_invalid_pixels=True))
    if size is not None:
        assert (tdec.width, tdec.height) == size
    if name == "vga_radtan":
        assert round(tdec.cx, 4) == 335.2176 and round(tdec.cy, 4) == 251.2821
    tmap, jmap = tm.undistortion_map(tdec), jm.undistortion_map(jdec)
    assert tmap.shape == (tdec.height, tdec.width, 2) and tmap.dtype == np.float32
    np.testing.assert_allclose(tmap, jmap, atol=MAP_ATOL, rtol=0)
    px = np.linspace(0.5, tm.width - 0.5, 7)
    py = np.linspace(0.5, tm.height - 0.5, 7)
    for a, b in zip(tcam._unproject_normalized(tm, px, py),
                    jcam._unproject_normalized(jm, px, py)):
        np.testing.assert_array_equal(a, b)


def test_create_undistortion_map_matches_jax():
    jp, tp = _pinholes(96, 72)
    jm, tm, _ = _models("radtan4")
    jdec = jcam.decide_undistorted_camera(jm)
    tdec = tcam.decide_undistorted_camera(tm)
    k = (tm.k1, tm.k2, tm.p1, tm.p2)
    jmap = jpre.create_undistortion_map(jpre.radtan_distort_fn(jm.pinhole, *k), jdec,
                                        jdec.height, jdec.width)
    tmap = tpre.create_undistortion_map(tpre.radtan_distort_fn(tm.pinhole, *k), tdec,
                                        tdec.height, tdec.width, device="cpu")
    np.testing.assert_allclose(tmap.numpy(), np.asarray(jmap), atol=MAP_ATOL, rtol=0)
    # radtan_distort_fn is the camera model's own projection.
    assert torch.equal(tmap, tpre.create_undistortion_map(
        tm.project_normalized, tdec, tdec.height, tdec.width, device="cpu"))
    if not torch.cuda.is_available():  # an entry point: the card unless asked
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpre.create_undistortion_map(tm.project_normalized, tdec, tdec.height, tdec.width)
    # The loader's host map and the device map agree to a few float32 ulp
    # (7.6e-6 at 100 px): they evaluate the model in other orders.
    np.testing.assert_allclose(tmap.numpy(), tm.undistortion_map(tdec), atol=5e-5, rtol=0)


def _rendered_distorted(seed=3, w=96, h=72, k=(-0.06, 0.01, 0.001, -0.002)):
    """A rendered distorted frame: raw u16 depth with holes, gray u8 rgb,
    the source model and its decided pinhole with the map."""
    jp, tp = _pinholes(w, h)
    jm = jcam.RadTanCamera(pinhole=jp, k1=k[0], k2=k[1], p1=k[2], p2=k[3])
    tm = tcam.RadTanCamera(pinhole=tp, k1=k[0], k2=k[1], p1=k[2], p2=k[3])
    scene = tsyn.random_plane_scene(np.random.default_rng(seed), 5)
    depth, inten = tsyn.render_scene_radtan(tm, scene, tsyn.pose(tx=0.01, rz=0.02))
    rng = np.random.default_rng(seed)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    depth_u16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
    gray = np.clip(inten * 255.0 + 0.5 + rng.normal(0, 20, inten.shape), 0, 255).astype(np.uint8)
    rgb = np.stack([gray, np.roll(gray, 3, 1), 255 - gray], axis=-1)
    dec = tcam.decide_undistorted_camera(tm)
    return depth_u16, rgb, tm, jm, dec, tm.undistortion_map(dec)


def test_undistort_image_matches_jax():
    depth_u16, rgb, _, _, _, umap = _rendered_distorted()
    # A few map entries outside the source: 0 there, by the map's test.
    umap = umap.copy()
    umap[0, :5] = [-0.2, 3.0]
    umap[-1, -4:] = [100.0, 71.9]
    depth = depth_u16.astype(np.float32) / 5000.0
    tmap, jmap = torch.from_numpy(umap), jnp.asarray(umap)
    out = tpre.undistort_image(torch.from_numpy(depth), tmap, nearest=True)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jpre.undistort_image(jnp.asarray(depth), jmap, nearest=True)))
    assert float(out[0, 0]) == 0.0 and int((out > 0).sum()) > 0.8 * out.numel()
    rgbf = rgb.astype(np.float32)
    for img in (rgbf, rgbf[..., 1]):
        out = tpre.undistort_image(torch.from_numpy(img), tmap).numpy()
        ref = np.asarray(jpre.undistort_image(jnp.asarray(img), jmap))
        np.testing.assert_allclose(out, ref, atol=MAP_ATOL, rtol=0)
        assert out.shape == ref.shape
    out = tpre.undistort_image(torch.from_numpy(rgb), tmap, nearest=True)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jpre.undistort_image(jnp.asarray(rgb), jmap, nearest=True)))


@pytest.mark.parametrize("passes", [1, 2])
def test_median_filter_and_densify_matches_jax(passes):
    rng = np.random.default_rng(40 + passes)
    depth = rng.uniform(0.5, 3.0, (37, 53)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.35] = 0.0
    depth[10:14, 20:26] = 0.0  # a hole larger than the window
    # Even counts whose two middles lie equally far from the mean.
    depth[30:33, 5:8] = 0.0
    depth[30, 5], depth[30, 6], depth[31, 5], depth[31, 6] = 1.0, 2.0, 3.0, 4.0
    t, j = torch.from_numpy(depth), jnp.asarray(depth)
    for _ in range(passes):
        t = tpre.median_filter_and_densify(t)
        j = jpre.median_filter_and_densify(j)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int((t > 0).sum()) > int((torch.from_numpy(depth) > 0).sum())


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_downscales_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    depth = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    depth[rng.uniform(size=shape) < 0.4] = 0.0
    depth[:4, :4] = 0.0
    out = tpre.downscale_depth_median(torch.from_numpy(depth))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jpre.downscale_depth_median(jnp.asarray(depth))))
    assert out.shape == (shape[0] // 2, shape[1] // 2)
    rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    out = tpre.downscale_color(torch.from_numpy(rgb))
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), np.asarray(jpre.downscale_color(jnp.asarray(rgb))))
    rgbf = rgb.astype(np.float32)
    np.testing.assert_array_equal(tpre.downscale_color(torch.from_numpy(rgbf)).numpy(),
                                  np.asarray(jpre.downscale_color(jnp.asarray(rgbf))))


def test_preprocess_frame_with_undistortion_and_median_matches_jax():
    """One frame of the distorted main path: raw u16 depth, undistortion,
    one median pass, then the bilateral filter and the rest (the JAX
    package through its plain XLA bilateral filter)."""
    depth_u16, rgb, _, _, dec, umap = _rendered_distorted(seed=8)
    jdec = jcam.PinholeCamera(fx=dec.fx, fy=dec.fy, cx=dec.cx, cy=dec.cy,
                              width=dec.width, height=dec.height)
    cf = np.zeros(((dec.height - 1) // 4 + 1, (dec.width - 1) // 4 + 1), np.float32)
    jf = jpre.preprocess_frame(jdec, jnp.asarray(depth_u16), jnp.asarray(rgb), max_depth=3.0,
                               a=0.0, cfactor=jnp.asarray(cf), use_pallas=False,
                               undistort_map=jnp.asarray(umap), raw_to_float_depth=1.0 / 5000.0,
                               median_iterations=1)
    tf = tpre.preprocess_frame(dec, torch.from_numpy(depth_u16.astype(np.int32)),
                               torch.from_numpy(rgb), max_depth=3.0, a=torch.zeros(()),
                               cfactor=torch.from_numpy(cf), raw_to_float_depth=1.0 / 5000.0,
                               undistort_map=torch.from_numpy(umap), median_iterations=1)
    assert tf.depth.shape == (dec.height, dec.width)
    for name, atol in (("depth", 1e-5), ("raw_depth", 1e-5), ("radius2", 1e-5),
                       ("nx", 1e-4), ("ny", 1e-4), ("intensity", 1.0 / 255.0 + 1e-6)):
        np.testing.assert_allclose(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                                   atol=atol, rtol=0, err_msg=name)
    # Brightness is floor(luma + 0.5) of bilinear values: a pixel whose luma
    # lies within float noise of a half may round the other way.
    assert float((tf.intensity - torch.from_numpy(np.array(jf.intensity))).abs().gt(0)
                 .float().mean()) < 0.002
    assert tf.rgb.dtype == torch.uint8
    assert int((tf.rgb.to(torch.int16) - torch.from_numpy(np.array(jf.rgb)).to(torch.int16))
               .abs().max()) <= 1
    assert int((tf.depth > 0).sum()) > 0.5 * tf.depth.numel()


def test_associate_frames_matches_jax():
    rng = np.random.default_rng(2)
    rgb = [(1.0 + i / 30.0 + rng.uniform(-0.002, 0.002), f"rgb/{i}.png") for i in range(40)]
    depth = [(1.0 + i / 30.0 + 0.007 + rng.uniform(-0.01, 0.01), f"depth/{i}.png")
             for i in range(40) if i % 7 != 3]
    rgb = rgb[::-1]  # the lists need not be sorted
    pairs = tds.associate_frames(rgb, depth)
    assert pairs == jds.associate_frames(rgb, depth)
    assert 30 < len(pairs) < 40
    assert tds.associate_frames(rgb, depth, 0.005) == jds.associate_frames(rgb, depth, 0.005)


def test_tum_fixture_loads_like_jax():
    """tests/data/tum_fixture: a 64x48 radtan calibration and raw rgb.txt/
    depth.txt lists with one dropped depth frame."""
    tv, jv = tds.load_tum_dataset(FIXTURE), jds.load_tum_dataset(FIXTURE)
    assert len(tv) == len(jv) == 5
    assert tv.color_paths == jv.color_paths and tv.depth_paths == jv.depth_paths
    assert tv.timestamps == jv.timestamps
    _same_camera(tv.camera, jv.camera)
    assert (tv.camera.width, tv.camera.height) == (62, 46)
    np.testing.assert_allclose(tv.undistortion_map, jv.undistortion_map, atol=MAP_ATOL, rtol=0)
    tv2, jv2 = (m.load_tum_dataset(FIXTURE, "groundtruth.txt") for m in (tds, jds))
    for pt, pj in zip(tv2.poses, jv2.poses):
        np.testing.assert_allclose(pt.t, np.asarray(pj.t), atol=1e-7, rtol=0)


def test_render_scene_radtan_matches_jax():
    jp, tp = _pinholes(80, 60)
    k = dict(k1=-0.07, k2=0.012, p1=0.001, p2=-0.0015)
    scene_t = tsyn.random_plane_scene(np.random.default_rng(4), 5)
    scene_j = jsyn.random_plane_scene(np.random.default_rng(4), 5)
    for p_t, p_j in zip(tsyn.smooth_trajectory(3), jsyn.smooth_trajectory(3)):
        dt, it = tsyn.render_scene_radtan(tcam.RadTanCamera(pinhole=tp, **k), scene_t, p_t)
        dj, ij = jsyn.render_scene_radtan(jcam.RadTanCamera(pinhole=jp, **k), scene_j, p_j)
        np.testing.assert_allclose(dt, dj, atol=1e-6, rtol=0)
        np.testing.assert_allclose(it, ij, atol=1e-6, rtol=0)
        assert (dt > 0).mean() > 0.9


def test_distorted_dataset_writer_matches_jax(tmp_path):
    """The port's writer with `distortion=` against the JAX package's: the
    same calibration line and the same images; raw TUM lists then load to
    the same frames in both loaders."""
    cam_t, cam_j = tsyn.default_camera(48, 36), jsyn.default_camera(48, 36)
    dist = (-0.05, 0.01)
    tsyn.write_tum_dataset(str(tmp_path / "t"), cam_t,
                           tsyn.random_plane_scene(np.random.default_rng(6), 4),
                           tsyn.smooth_trajectory(4), distortion=dist)
    jsyn.write_tum_dataset(str(tmp_path / "j"), cam_j,
                           jsyn.random_plane_scene(np.random.default_rng(6), 4),
                           jsyn.smooth_trajectory(4), distortion=dist)
    for name in ("calibration.txt", "associated.txt", "groundtruth.txt"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    tsyn.make_raw_tum_lists(str(tmp_path / "t"), depth_offset_s=0.007, drop_depth=(2,))
    tv, jv = tds.load_tum_dataset(str(tmp_path / "t")), jds.load_tum_dataset(str(tmp_path / "t"))
    assert len(tv) == len(jv) == 3 and tv.timestamps == jv.timestamps
    _same_camera(tv.camera, jv.camera)
    for i in range(3):
        np.testing.assert_array_equal(tv.depth_u16(i), jv.depth_u16(i))
        np.testing.assert_array_equal(tv.color_u8(i), jv.color_u8(i))
        np.testing.assert_array_equal(
            tv.depth_u16(i), jds._imread_depth(str(tmp_path / "j" / "depth" / f"{[0, 1, 3][i]:05d}.png")))


def _trajectory(path):
    _, poses = tds.load_tum_trajectory(path)
    return (np.stack([p.q for p in poses]).astype(np.float64),
            np.stack([p.t for p in poses]).astype(np.float64), poses)


def _cli_pair(data, tmp_path, flags):
    out = {k: str(tmp_path / f"{k}.txt") for k in ("jax", "torch")}
    assert jax_main([data, *flags, "--export_poses", out["jax"]]) == 0
    assert torch_main([data, "--device", "cpu", *flags, "--export_poses", out["torch"]]) == 0
    (qj, tj, pj), (qt, tt, pt) = _trajectory(out["jax"]), _trajectory(out["torch"])
    assert len(pt) == len(pj)
    np.testing.assert_allclose(tt, tj, atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(qt, qj, atol=POSE_ATOL, rtol=0)
    return pt, pj


def test_fixture_cli_matches_jax_cli(tmp_path):
    """The repo's distorted raw-TUM fixture through both CLIs with BA on:
    5 frames undistorted to 62x46, a keyframe every 2 frames."""
    pt, _ = _cli_pair(FIXTURE, tmp_path, ["--num_scales", "2", "--keyframe_interval", "2",
                                          "--max_num_ba_iterations_per_keyframe", "4",
                                          *CLI_FLAGS])
    assert len(pt) == 5


def test_input_pyramid_cli_matches_jax_cli(tmp_path):
    """A 128x96 source processed at input pyramid level 1 (64x48)."""
    data = str(tmp_path / "seq")
    gt = tsyn.smooth_trajectory(7)
    tsyn.write_tum_dataset(data, tsyn.default_camera(128, 96),
                           tsyn.random_plane_scene(np.random.default_rng(12), 5), gt)
    pt, _ = _cli_pair(data, tmp_path, ["--num_scales", "3", "--keyframe_interval", "3",
                                       "--max_num_ba_iterations_per_keyframe", "4",
                                       "--pyramid_level_for_depth", "1",
                                       "--pyramid_level_for_color", "1", *CLI_FLAGS])
    assert tsyn.ate_rmse(pt, gt) < 2e-3


def test_input_level_refusals_match_jax(tmp_path):
    """The JAX package's refusals of the input pyramid, with its type."""
    from badslam_torch.config import BadSlamConfig
    from badslam_torch.frontend import BadSlam, check_supported

    base = dict(enable_loop_detection=False)
    for kw in (dict(pyramid_level_for_depth=1),
               dict(pyramid_level_for_depth=1, pyramid_level_for_color=1,
                    median_filter_and_densify_iterations=1)):
        with pytest.raises(NotImplementedError):
            check_supported(BadSlamConfig(**base, **kw))
    with pytest.raises(NotImplementedError, match="undistortion"):
        BadSlam(BadSlamConfig(**base, pyramid_level_for_depth=1, pyramid_level_for_color=1),
                tds.load_tum_dataset(FIXTURE), "cpu")
    slam = BadSlam(BadSlamConfig(**base, median_filter_and_densify_iterations=2),
                   tds.load_tum_dataset(FIXTURE), "cpu")
    assert slam._undistort_map.shape == (46, 62, 2)
    assert convert.camera_from_numpy(slam.cam) == slam.cam


def reference_ate_of_chip_smoke_input(workdir: str) -> dict:
    """ATE (m) of the JAX CLI and of the port's CLI on the CPU over
    chip_smoke.py's distorted raw VGA input (20 frames, one median pass,
    BA and the final BA): the reference for that phase's ATE limit. Also
    both packages without the median pass, and on the same scene and
    trajectory through the pinhole camera alone (no distortion, no
    median), which separate what undistortion and the median each cost.
    Minutes of CPU time, so not a test; from the repo root run
    `PYTHONPATH=. python tests/test_torch_input.py`."""
    import chip_smoke

    data, gt_kept = chip_smoke.write_input_sequence(workdir)
    pinhole = os.path.join(workdir, "pinhole")
    gt = tsyn.smooth_trajectory(chip_smoke.INPUT_FRAMES)
    tsyn.write_tum_dataset(pinhole, chip_smoke.INPUT_CAMERA,
                           tsyn.random_plane_scene(np.random.default_rng(7), 6), gt)
    flags = chip_smoke.INPUT_FLAGS
    i = flags.index("--median_filter_and_densify_iterations")
    no_median = [*flags[:i], *flags[i + 2:]]
    out = {}
    for name, seq, truth, args in (
            ("jax", data, gt_kept, flags),
            ("torch_cpu", data, gt_kept, ["--device", "cpu", *flags]),
            ("jax_no_median", data, gt_kept, no_median),
            ("torch_cpu_no_median", data, gt_kept, ["--device", "cpu", *no_median]),
            ("jax_pinhole", pinhole, gt, no_median),
            ("torch_cpu_pinhole", pinhole, gt, ["--device", "cpu", *no_median])):
        path = os.path.join(workdir, f"{name}.txt")
        main = torch_main if name.startswith("torch") else jax_main
        assert main([seq, *args, "--export_poses", path]) == 0
        _, poses = tds.load_tum_trajectory(path)
        out[name] = tsyn.ate_rmse(poses, truth)
        print(name, out[name], flush=True)
    return out


if __name__ == "__main__":
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as workdir:
        print(reference_ate_of_chip_smoke_input(workdir))
