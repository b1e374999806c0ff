"""The port's self-calibration (badslam_torch/ba/intrinsics_opt.py) against
the JAX package.

tests/test_intrinsics.py's fixture (128x96 rendered plane scene, six
keyframes with surfels), built by the JAX package and carried into the port
(badslam_torch.convert), with the keyframes' raw depth miscalibrated by a
known cfactor and, where the camera is solved for, a perturbed camera.

Tolerances:
  * recalibrated planes: depth / radius2 atol 1e-5, nx / ny atol 1e-4,
    test_torch_preprocess.py's holds for preprocess_frame: the deformed
    depths differ by an ulp (exp and division in another order), and
    normals are central differences of points ~2 cm apart, which makes
    that ~1e-5 in nx, ny;
  * the global sums A, b1 (depth) and H, b (color): rtol 1e-4 with atol
    1e-4 x the largest entry. Both packages sum the same float32 terms
    over ~5000 (keyframe, surfel) pairs in another order;
  * the per-cell sums B, D, b2 and counts obs: the same hold, and exact
    counts, on every cell but at most 1 % of the observed ones. A surfel
    that projects within an ulp of a pixel border (pxy_y = 23.999998 on
    this fixture) lands one pixel over under XLA's fused arithmetic, and
    with it its observation moves to the next cell: measured 4 of 660
    cells, the totals equal;
  * the Schur reduction, the float64 solve, the back-substitution and the
    camera updates on the same (JAX) system: rtol 1e-5 (float32 inputs in
    another order) and 1e-12 for the host float64 camera arithmetic;
  * the camera, a and cfactor after 1-3 steps, each package on its own
    system: the reduced 5x5 depth system has a condition number of ~1e8
    here, so the ~1e-5 relative differences of b1_r above move x1 by up
    to ~4e-3 of its largest entry. Held, per case, at ~3x the gap
    measured on this fixture: depth only 2.5e-4 relative on fx..cy, a
    atol 3e-3, cfactor atol 2e-4 (values ~1e-2); joint 4e-5, 1.5e-3 and
    3e-5 (the photometric terms condition the system better); color only
    (4x4, no cells) 1e-6 relative.
The color system is 180 x intensity differences, like the descriptors
(test_torch_mapping.py's DESC_ATOL), but each of its terms is a product
of two such differences, so it is held relatively, like the depth sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.ba import intrinsics_opt as jio
from badslam_tpu.ba.scheme import DirectBA as JDirectBA
from badslam_tpu.config import BadSlamConfig as JConfig
from badslam_tpu import synthetic as jsyn
from badslam_torch import convert
from badslam_torch.ba import intrinsics_opt as tio
from badslam_torch.ba.scheme import DirectBA as TDirectBA
from badslam_torch.config import BadSlamConfig as TConfig

import fixtures

torch.set_num_threads(1)

CELL = 4
CAP = 1 << 13
DEV = "cpu"
CF_GT = 0.01
# (camera rtol, a atol, cfactor atol) per case, see the module docstring.
STEP_HOLD = {"depth": (2.5e-4, 3e-3, 2e-4), "joint": (4e-5, 1.5e-3, 3e-5),
             "color": (1e-6, 0.0, 0.0)}
CELL_FLIPS = 0.01


def _build(seed, num_kf=6):
    """test_intrinsics.py's build_ba, then the JAX DirectBA carried into a
    port DirectBA (same map, keyframes, camera, depth parameters)."""
    rng = np.random.default_rng(seed)
    cam = jsyn.default_camera(128, 96)
    scene = jsyn.random_plane_scene(rng, 4)
    j = JDirectBA(cam, JConfig(max_surfel_count=CAP, sparse_surfel_cell_size=CELL),
                  surfel_capacity=CAP)
    for i in range(num_kf):
        g = jsyn.pose(tx=0.05 * i, ry=0.01 * i, ty=0.02 * (i % 2))
        d, inten = jsyn.render_scene(cam, scene, g)
        f = fixtures.frame_from_render(cam, d, inten)
        j.add_keyframe(f._replace(raw_depth=f.depth), g, i)
    j.create_surfels_for_keyframe(0, filter_new_surfels=False)
    for i in range(1, num_kf):
        j.create_surfels_for_keyframe(i, filter_new_surfels=True)
    j.surfels = j.surfels._replace(active=j.surfels.valid)
    return cam, j


def _miscalibrate(j):
    """Raw depth such that calibrating with cfactor = CF_GT gives the
    rendered depth; the keyframes' planes re-derived with identity
    parameters (test_intrinsics.py's depth case)."""
    ks = j.keyframes
    gt = np.asarray(ks.depth)
    raw = np.where(gt > 0, 1.0 / (1.0 / np.maximum(gt, 1e-6) - CF_GT), 0.0)
    ks.raw_depth = jnp.array(raw.astype(np.float32))
    j.depth_params = jio.empty_depth_params(j.cam.height, j.cam.width, CELL)
    ks.recalibrate(j.cam, j.depth_params.a, j.depth_params.cfactor, CELL)
    return gt


def _port_of(j):
    tcam = convert.camera_from_numpy(j.cam)
    t = TDirectBA(tcam, TConfig(max_surfel_count=CAP, sparse_surfel_cell_size=CELL),
                  surfel_capacity=CAP, device=DEV)
    t.surfels = convert.surfel_map_from_numpy(j.surfels, DEV)
    t.keyframes = convert.keyframe_store_from_numpy(j.keyframes, tcam, DEV)
    t.depth_params = convert.depth_params_from_numpy(
        np.asarray(j.depth_params.a), np.asarray(j.depth_params.cfactor), DEV)
    t.ba_iteration_count = j.ba_iteration_count
    return t


@pytest.fixture(scope="module")
def miscalibrated():
    cam, j = _build(11)
    gt = _miscalibrate(j)
    return cam, j, gt


def _bad_camera(cam):
    return cam.with_intrinsics(fx=cam.fx * 1.004, fy=cam.fy, cx=cam.cx + 0.5,
                               cy=cam.cy - 0.5)


def _close(got, want, rtol=1e-4, name=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _cam_close(tcam, jcam, rtol):
    got = [tcam.fx, tcam.fy, tcam.cx, tcam.cy]
    want = [float(jcam.fx), float(jcam.fy), float(jcam.cx), float(jcam.cy)]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _systems(j, t, jcam, optimize_depth, optimize_color):
    k = t.keyframes.count
    jsys = jio.accumulate_intrinsics_coeffs(
        j.surfels, jcam, j.keyframes.stack(), j.keyframes.stack_raw(),
        j.depth_params, baseline_fx=40.0, cell_size=CELL,
        optimize_depth=optimize_depth, optimize_color=optimize_color)
    tsys = tio.accumulate_intrinsics_coeffs(
        t.surfels, convert.camera_from_numpy(jcam), t.keyframes.stack(),
        t.keyframes.stack_raw(), t.depth_params, baseline_fx=40.0,
        cell_size=CELL, optimize_depth=optimize_depth,
        optimize_color=optimize_color)
    assert t.keyframes.stack_raw().shape[0] == k
    return jsys, tsys


def test_recalibrate_planes_matches_jax(miscalibrated):
    cam, j, _ = miscalibrated
    t = _port_of(j)
    rng = np.random.default_rng(3)
    cf = (0.01 + 0.002 * rng.standard_normal(j.depth_params.cfactor.shape)).astype(np.float32)
    a = np.float32(0.05)
    raw = np.array(j.keyframes.stack_raw())[: t.keyframes.count]
    want = jio.recalibrate_planes(cam, jnp.array(raw), jnp.float32(a), jnp.array(cf),
                                  cell_size=CELL)
    got = tio.recalibrate_planes(t.cam, torch.from_numpy(raw), torch.tensor(a),
                                 torch.from_numpy(cf), cell_size=CELL)
    for name, g, w in zip(("depth", "nx", "ny", "radius2"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, err_msg=name,
                                   atol=1e-4 if name in ("nx", "ny") else 1e-5)
    assert (got[0] > 0).float().mean() > 0.5


def _same_cells(td, jd):
    """The cells whose observation count agrees (all but the border
    flips, see the module docstring), checked to be nearly all."""
    obs_t, obs_j = td[5].numpy(), np.asarray(jd[5])
    same = obs_t == obs_j
    assert obs_t.sum() == obs_j.sum()
    assert (~same).sum() <= CELL_FLIPS * (obs_j > 0).sum(), (~same).sum()
    return same


@pytest.mark.parametrize("depth,color", [(True, False), (False, True), (True, True)],
                         ids=["depth", "color", "joint"])
def test_accumulate_intrinsics_coeffs_matches_jax(miscalibrated, depth, color):
    cam, j, _ = miscalibrated
    t = _port_of(j)
    jcam = _bad_camera(cam)
    (jd, jc), (td, tc) = _systems(j, t, jcam, depth, color)
    if depth:
        same = _same_cells(td, jd)
        for name, g, w in zip(("A", "b1"), td[:2], jd[:2]):
            _close(g, w, name=name)
        for name, g, w in zip(("B", "D", "b2"), td[2:5], jd[2:5]):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy()[same], w[same], rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=name)
        assert int(td[5].sum()) > 4000
    else:
        assert all(float(x.abs().sum()) == 0 for x in td)
    if color:
        for name, g, w in zip(("H", "b"), tc, jc):
            _close(g, w, name=name)
        assert float(tc[0].abs().max()) > 0
    else:
        assert all(float(x.abs().sum()) == 0 for x in tc)


def _to_torch(system):
    return tuple(torch.from_numpy(np.array(x)) for x in system)


def test_schur_reduce_solve_and_backsubstitute_match_jax(miscalibrated):
    """The steps after the accumulation, on the JAX package's own system."""
    cam, j, _ = miscalibrated
    t = _port_of(j)
    (jd, jc), _ = _systems(j, t, _bad_camera(cam), True, True)
    jr = jio.schur_reduce(jd)
    tr = tio.schur_reduce(_to_torch(jd))
    for name, g, w in zip(("A_r", "b1_r", "DiB", "Dib2"), tr[:4], jr[:4]):
        _close(g, w, rtol=1e-5, name=name)
    np.testing.assert_array_equal(tr[4].numpy(), np.asarray(jr[4]))
    np.testing.assert_array_equal(tr[5].numpy(), np.asarray(jr[5]))
    jx = jio.solve_depth_intrinsics(jr[0], jr[1], j.depth_params.a)
    tx = tio.solve_depth_intrinsics(tr[0], tr[1], t.depth_params.a)
    assert tx.dtype == np.float32 and np.abs(jx).max() > 0
    _close(tx, jx, rtol=1e-5, name="x1")
    jp = jio.backsubstitute_cfactor(j.depth_params, jx, *jr[2:])
    tp = tio.backsubstitute_cfactor(t.depth_params, jx, *tr[2:])
    np.testing.assert_allclose(float(tp.a), float(jp.a), atol=1e-7, rtol=0)
    _close(tp.cfactor, jp.cfactor, rtol=1e-5, name="cfactor")
    bad = _bad_camera(cam)
    tbad = convert.camera_from_numpy(bad)
    _cam_close(tio.updated_depth_camera(tbad, jx), jio.updated_depth_camera(bad, jx),
               rtol=1e-12)
    np.testing.assert_array_equal(tio._color_to_inverse_param_T(tbad),
                                  jio._color_to_inverse_param_T(bad))
    xc = jio.solve_color_intrinsics(jc)
    _close(tio.solve_color_intrinsics(_to_torch(jc)), xc, rtol=1e-5, name="color x")
    _cam_close(tio.updated_color_camera(tbad, xc), jio.updated_color_camera(bad, xc),
               rtol=1e-12)


@pytest.mark.parametrize("depth,color", [(True, False), (False, True), (True, True)],
                         ids=["depth", "color", "joint"])
def test_optimize_intrinsics_matches_jax(miscalibrated, depth, color):
    """Three intrinsics steps from a perturbed camera, each package on its
    own state: the camera and the depth parameters stay together."""
    cam_rtol, a_atol, cf_atol = STEP_HOLD[
        "joint" if depth and color else "depth" if depth else "color"]
    cam, j, _ = miscalibrated
    t = _port_of(j)
    jcam, jparams = _bad_camera(cam), j.depth_params
    tcam, tparams = convert.camera_from_numpy(jcam), t.depth_params
    for _ in range(3):
        jcam, jparams = jio.optimize_intrinsics(
            j.surfels, jcam, j.keyframes.stack(), j.keyframes.stack_raw(), jparams,
            baseline_fx=40.0, cell_size=CELL, optimize_depth=depth,
            optimize_color=color)
        tcam, tparams = tio.optimize_intrinsics(
            t.surfels, tcam, t.keyframes.stack(), t.keyframes.stack_raw(), tparams,
            baseline_fx=40.0, cell_size=CELL, optimize_depth=depth,
            optimize_color=color)
        _cam_close(tcam, jcam, cam_rtol)
        np.testing.assert_allclose(float(tparams.a), float(jparams.a), atol=a_atol, rtol=0)
        np.testing.assert_allclose(tparams.cfactor.numpy(), np.asarray(jparams.cfactor),
                                   atol=cf_atol, rtol=0)
    assert abs(tcam.cx - (cam.cx + 0.5)) > 0.05  # the camera moved


def test_optimize_intrinsics_step_matches_jax(miscalibrated):
    """DirectBA.optimize_intrinsics_step: the camera, the depth parameters
    and the keyframes' re-derived planes."""
    cam_rtol, _, cf_atol = STEP_HOLD["joint"]
    cam, _, _ = miscalibrated
    _, j = _build(11)
    _miscalibrate(j)
    j.cam = _bad_camera(cam)
    t = _port_of(j)
    for _ in range(2):
        j.optimize_intrinsics_step(True, True)
        t.optimize_intrinsics_step(True, True)
        assert t.intrinsics_updated and j.intrinsics_updated
        _cam_close(t.cam, j.cam, cam_rtol)
        np.testing.assert_allclose(t.depth_params.cfactor.numpy(),
                                   np.asarray(j.depth_params.cfactor), atol=cf_atol, rtol=0)
    k = t.keyframes.count
    for name in ("depth", "nx", "ny", "radius2", "min_depth", "max_depth"):
        np.testing.assert_allclose(getattr(t.keyframes, name)[:k].numpy(),
                                   np.asarray(getattr(j.keyframes, name))[:k],
                                   atol=1e-4, rtol=0, err_msg=name)
    assert len(t.intrinsics_spans.ms()) == 2


# -- the port on its own: tests/test_intrinsics.py's recovery cases ----------


def test_port_depth_deformation_recovery():
    cam, j = _build(11)
    gt_depth = _miscalibrate(j)
    t = _port_of(j)
    ks = t.keyframes
    k = ks.count
    gt_depth = gt_depth[:k]
    err0 = float(np.mean(np.abs(ks.depth[:k].numpy()[gt_depth > 0] - gt_depth[gt_depth > 0])))
    assert err0 > 1e-3
    for _ in range(5):
        t.optimize_intrinsics_step(optimize_depth_intrinsics=True,
                                   optimize_color_intrinsics=False)
    cf = t.depth_params.cfactor.numpy()
    observed = np.abs(cf) > 1e-6
    assert observed.mean() > 0.3
    assert abs(np.median(cf[observed]) - CF_GT) < 0.2 * CF_GT
    ys, xs = np.mgrid[0:cam.height, 0:cam.width]
    px = observed[ys // CELL, xs // CELL][None] & (gt_depth > 0)
    err1 = float(np.mean(np.abs(ks.depth[:k].numpy()[px] - gt_depth[px])))
    assert err1 < 0.25 * err0, (err0, err1)


def _recovery(seed, bad, depth, color, steps, err):
    cam, j = _build(seed)
    t = _port_of(j)
    tcam = convert.camera_from_numpy(bad(cam))
    err0 = err(tcam, cam)
    params = t.depth_params
    for _ in range(steps):
        tcam, params = tio.optimize_intrinsics(
            t.surfels, tcam, t.keyframes.stack(), t.keyframes.stack_raw(), params,
            baseline_fx=40.0, cell_size=CELL, optimize_depth=depth,
            optimize_color=color)
    err1 = err(tcam, cam)
    assert np.isfinite(err1)
    assert err1 < 0.5 * err0, (err0, err1)


def test_port_joint_depth_and_color_intrinsics_recovery():
    _recovery(17, _bad_camera, True, True, 6,
              lambda c, g: (abs(c.fx - g.fx) / g.fx * 100.0 + abs(c.cx - g.cx)
                            + abs(c.cy - g.cy)))


def test_port_color_intrinsics_recovery():
    _recovery(13, lambda c: c.with_intrinsics(fx=c.fx, fy=c.fy, cx=c.cx + 0.6,
                                              cy=c.cy - 0.6),
              False, True, 5, lambda c, g: abs(c.cx - g.cx) + abs(c.cy - g.cy))


# -- resuming a self-calibrated run -----------------------------------------


def test_self_calibrated_jax_snapshot_resumes_in_the_port(tmp_path):
    """A JAX run with optimize_intrinsics, snapshotted after self-calibrating
    BA calls (the 10th keyframe at frame 18), resumed by both packages: the
    port takes the snapshot's calibrated camera everywhere it holds one
    (1e-6 relative, the snapshot's float64 copy of float32 values) and
    continues within 1e-4 of the JAX package's own resumed run (poses; the
    next keyframe self-calibrates again)."""
    from badslam_tpu.frontend import BadSlam as JBadSlam
    from badslam_tpu.io import dataset as jds
    from badslam_tpu.io import state as jstate
    from badslam_torch import synthetic as tsyn
    from badslam_torch.io import dataset as tds
    from badslam_torch.io import state as tstate
    from test_torch_calibration_slice import write_miscalibrated_sequence

    data = str(tmp_path / "seq")
    cam = tsyn.default_camera(64, 48)
    write_miscalibrated_sequence(data, cam)
    cfg = dict(num_scales=3, keyframe_interval=2, max_num_ba_iterations_per_keyframe=2,
               optimize_intrinsics=True, enable_loop_detection=False, fps_restriction=0,
               max_surfel_count=1 << 14)
    jslam = JBadSlam(JConfig(**cfg), jds.load_tum_dataset(data))
    dataset_cam = jslam.cam
    jslam.run(start=0, end=20)
    snap = str(tmp_path / "s.npz")
    jstate.save_state(jslam, snap)
    calibrated = [float(jslam.cam.fx), float(jslam.cam.fy), float(jslam.cam.cx),
                  float(jslam.cam.cy)]
    assert abs(calibrated[2] - float(dataset_cam.cx)) > 1e-3

    tslam = tstate.load_state(snap, tds.load_tum_dataset(data), "cpu")
    for held in (tslam.cam, tslam.direct_ba.cam, tslam.direct_ba.keyframes.cam,
                 tslam.cams_pyramid[0]):
        np.testing.assert_allclose([held.fx, held.fy, held.cx, held.cy], calibrated,
                                   rtol=1e-6, atol=0)
    assert tslam.cams_pyramid[1] == tslam.cam.pyramid_level(1)

    jres = jstate.load_state(snap, jds.load_tum_dataset(data))
    jres.run(start=jres.last_frame_index + 1)
    tslam.run(start=tslam.last_frame_index + 1)
    assert tslam.has_pose.all() and jres.has_pose.all()
    np.testing.assert_allclose(tslam.traj_t.numpy(), np.asarray(jres.traj_t), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tslam.traj_q.numpy(), np.asarray(jres.traj_q), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        [tslam.cam.fx, tslam.cam.fy, tslam.cam.cx, tslam.cam.cy],
        [float(jres.cam.fx), float(jres.cam.fy), float(jres.cam.cx), float(jres.cam.cy)],
        rtol=STEP_HOLD["joint"][0], atol=0)
    assert tslam.cam.cx != calibrated[2]  # keyframe 11 self-calibrated again
