"""badslam_torch preprocessing and pyramid against badslam_tpu, and the
dispatch of the bilateral filter (K1) between its CUDA kernel and its plain
PyTorch version (the kernel itself is held to the plain version on the card
by tests/test_torch_cuda.py).

Inputs are made with numpy from fixed seeds and fed to both packages, at
160x120 and, for preprocessing and the pyramid, also at a ragged 73x45 (the
ETH3D SLAM camera scaled down: ragged sparse cells, and every pyramid level
drops a column or a row).
Tolerances:
  * bilateral filter: atol 1e-5, the Pallas kernel's own hold against its
    XLA reference (tests/test_pallas.py); outputs are depths of 0.5-3 m,
    where 1e-5 is ~40 float32 ulp, room for exp/division rounding and
    summation order.
  * preprocess_frame: atol 1e-5 on depths, radii and intensity; the
    pipeline is the same float32 arithmetic in another evaluation order,
    and the filtered depths differ by ~1e-6 m. Normals are central
    differences of neighbouring points ~2 cm apart at 2 m, so that 1e-6
    becomes ~5e-5 in nx, ny: their hold is atol 1e-4.
  * compute_normals and build_pyramid on identical inputs: atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.ba.intrinsics_opt import empty_depth_params
from badslam_tpu.ops import interp as jinterp
from badslam_tpu.ops import preprocess as jpre
from badslam_tpu.ops import pyramid as jpyr
from badslam_tpu.ops.pallas_kernels import bilateral_filter_and_cutoff_pallas
from badslam_tpu import synthetic as jsyn
from badslam_tpu.geometry.camera import PinholeCamera as JaxPinholeCamera
from badslam_torch import synthetic as tsyn
from badslam_torch.convert import camera_from_numpy, depth_params_from_numpy
from badslam_torch.geometry.camera import PinholeCamera
from badslam_torch.ops import interp as tinterp
from badslam_torch.ops import kernels
from badslam_torch.ops import preprocess as tpre
from badslam_torch.ops import pyramid as tpyr

torch.set_num_threads(1)

ATOL = 1e-5


def _depth_with_holes(seed, shape, max_depth):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    d[rng.uniform(size=shape) < 0.15] = 0.0
    d[rng.uniform(size=shape) < 0.05] = max_depth + 2.0  # beyond the cutoff
    return d


@pytest.mark.parametrize("shape", [(120, 160), (67, 160)], ids=["120x160", "67x160"])
def test_bilateral_plain_matches_jax_and_pallas(shape):
    d = _depth_with_holes(0, shape, 2.5)
    ref = np.asarray(jpre.bilateral_filter_and_cutoff(jnp.array(d), 2.5))
    pallas = np.asarray(bilateral_filter_and_cutoff_pallas(
        jnp.array(d), 2.5, block_h=32, interpret=True))
    out = tpre.bilateral_filter_and_cutoff(torch.from_numpy(d), 2.5).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=0)
    assert np.all(out[d > 2.5] == 0) and np.all(out[d == 0] == 0)


def test_bilateral_dispatch_cpu_uses_plain_version():
    d = _depth_with_holes(1, (24, 40), 2.5)
    kernels.reset_launch_counts()
    out = kernels.bilateral_filter(torch.from_numpy(d), 2.5)
    ref = tpre.bilateral_filter_and_cutoff(torch.from_numpy(d), 2.5)
    assert torch.equal(out, ref)
    assert kernels.launch_counts[kernels.BILATERAL] == 0
    with pytest.raises(ValueError):
        kernels.bilateral_filter_and_cutoff_cuda(torch.from_numpy(d), 2.5)


# The cameras of the golden cases: the tests' 160x120, and the ETH3D SLAM
# camera's intrinsics scaled by 73/739 (slam_bench/tests/data/tiny_eth3d.json):
# 73 % 4 = 1 and 45 % 8 = 5, so the 4-pixel sparse cells are ragged and
# every pyramid level drops a column or a row.
CAMERAS = {
    "160x120": tsyn.default_camera(160, 120),
    "eth3d_73x45": PinholeCamera(fx=71.7455, fy=71.7455, cx=35.0775, cy=18.4723, width=73,
                                 height=45),
}


def _render(seed, camera="160x120"):
    cam = CAMERAS[camera]
    scene = tsyn.random_plane_scene(np.random.default_rng(seed), 4)
    depth, inten = tsyn.render_scene(cam, scene, tsyn.pose(tx=0.01, rz=0.02))
    depth_u16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
    gray = np.clip(inten * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return cam, depth_u16, np.stack([gray] * 3, axis=-1)


def _frames(cam, depth_u16, rgb, max_depth=2.1):
    jcam = JaxPinholeCamera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
                            height=cam.height)
    params = empty_depth_params(cam.height, cam.width, 4)
    jf = jpre.preprocess_frame(
        jcam, jnp.array(depth_u16), jnp.array(rgb), max_depth=max_depth,
        a=params.a, cfactor=params.cfactor, cell_size=4, use_pallas=False,
        raw_to_float_depth=1.0 / 5000.0)
    a, cf = depth_params_from_numpy(np.asarray(params.a), np.asarray(params.cfactor), "cpu")
    tf = tpre.preprocess_frame(
        camera_from_numpy(jcam), torch.from_numpy(depth_u16.astype(np.int32)),
        torch.from_numpy(rgb), max_depth=max_depth, a=a, cfactor=cf,
        cell_size=4, raw_to_float_depth=1.0 / 5000.0)
    return jf, tf


@pytest.mark.parametrize("camera", list(CAMERAS))
def test_preprocess_frame_matches_jax(camera):
    jf, tf = _frames(*_render(3, camera))
    assert tuple(tf.depth.shape) == (CAMERAS[camera].height, CAMERAS[camera].width)
    for name in ("depth", "nx", "ny", "radius2", "intensity", "raw_depth"):
        np.testing.assert_allclose(getattr(tf, name).numpy(),
                                   np.asarray(getattr(jf, name)),
                                   atol=1e-4 if name in ("nx", "ny") else ATOL,
                                   rtol=0, err_msg=name)
    assert np.array_equal(tf.rgb.numpy(), np.asarray(jf.rgb))
    # The cutoff and the isolated-pixel removal left real work to compare.
    assert 0 < int((tf.depth > 0).sum()) < tf.depth.numel()


def test_normals_and_radii_match_jax():
    cam, depth_u16, _ = _render(6)
    d = depth_u16.astype(np.float32) / 5000.0
    jcam = jsyn.default_camera(cam.width, cam.height)
    jd, jnx, jny = jpre.compute_normals(jcam, jnp.array(d))
    td, tnx, tny = tpre.compute_normals(cam, torch.from_numpy(d))
    jd2, jr2 = jpre.compute_radii_and_remove_isolated(jcam, jd)
    td2, tr2 = tpre.compute_radii_and_remove_isolated(cam, td)
    for t, j in ((td, jd), (tnx, jnx), (tny, jny), (td2, jd2), (tr2, jr2)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def test_depth_deformation_matches_jax():
    rng = np.random.default_rng(4)
    d = rng.uniform(0.5, 3.0, (30, 41)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.2] = 0.0
    cf = rng.normal(scale=0.01, size=((30 - 1) // 4 + 1, (41 - 1) // 4 + 1)).astype(np.float32)
    for a in (0.0, 0.3):
        ref = np.asarray(jpre.apply_depth_deformation(
            jnp.array(d), jnp.float32(a), jnp.array(cf), 4))
        ta, tcf = depth_params_from_numpy(np.float32(a), cf, "cpu")
        out = tpre.apply_depth_deformation(torch.from_numpy(d), ta, tcf, 4).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("gradmag, camera", [
    pytest.param(False, "160x120", id="intensity"),
    pytest.param(True, "160x120", id="gradmag"),
    pytest.param(False, "eth3d_73x45", id="eth3d_73x45-intensity"),
    pytest.param(True, "eth3d_73x45", id="eth3d_73x45-gradmag")])
def test_build_pyramid_matches_jax(gradmag, camera):
    jf, _ = _frames(*_render(5, camera))
    jp = jpyr.build_pyramid(jf.depth, jf.nx, jf.ny, jf.intensity, 4, gradmag=gradmag)
    planes = [torch.from_numpy(np.array(p)) for p in (jf.depth, jf.nx, jf.ny, jf.intensity)]
    tp = tpyr.build_pyramid(*planes, 4, gradmag=gradmag)
    assert len(tp) == 4
    if camera == "eth3d_73x45":  # each level drops the odd column or row
        assert [tuple(level.depth.shape) for level in tp] == [
            (45, 73), (22, 36), (11, 18), (5, 9)]
    for level, (jl, tl) in enumerate(zip(jp, tp)):
        for name in tpyr.FramePyramidLevel._fields:
            np.testing.assert_allclose(getattr(tl, name).numpy(),
                                       np.asarray(getattr(jl, name)),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"level {level} {name}")


def test_interp_matches_jax():
    """Texel centers at +0.5 and clamp-to-edge, including coordinates off
    the image on every side."""
    rng = np.random.default_rng(8)
    img = rng.uniform(size=(13, 17)).astype(np.float32)
    x = rng.uniform(-2.0, 19.0, (40,)).astype(np.float32)
    y = rng.uniform(-2.0, 15.0, (40,)).astype(np.float32)
    ix = rng.integers(0, 17, (40,))
    iy = rng.integers(0, 13, (40,))
    ti, tx, ty = torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(
        tinterp.gather_nearest(ti, torch.from_numpy(ix), torch.from_numpy(iy)).numpy(),
        np.asarray(jinterp.gather_nearest(jnp.array(img), jnp.array(ix, jnp.int32),
                                          jnp.array(iy, jnp.int32))))
    np.testing.assert_allclose(
        tinterp.bilinear(ti, tx, ty).numpy(),
        np.asarray(jinterp.bilinear(jnp.array(img), jnp.array(x), jnp.array(y))),
        atol=1e-6, rtol=0)
    for t, j in zip(tinterp.bilinear_and_gradient(ti, tx, ty),
                    jinterp.bilinear_and_gradient(jnp.array(img), jnp.array(x), jnp.array(y))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=0)
