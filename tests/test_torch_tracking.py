"""badslam_torch pairwise tracking against badslam_tpu on rendered
plane-scene pairs at 160x120 (the setup of tests/test_tracking.py), and the
tracker with its duel also at a ragged 73x45 (the ETH3D SLAM camera scaled
down: every pyramid level drops a column or a row).

Both packages get the same base and tracked pyramids (built by the JAX
package, carried over with badslam_torch.convert) and the same poses.
Tolerances:
  * H, b: rtol 1e-4 (atol 1e-3 for entries that cancel to ~0): float32
    sums over ~10^4 pixels taken in another order (an XLA dot against a
    PyTorch matmul).
  * counts: exact; cost: rtol 1e-4, a float32 sum like H.
  * tracked pose: atol 1e-4 on q and t; Gauss-Newton converges to the same
    minimum from the same start, and the sums' rounding moves it by less.

On a CUDA tensor the tracker's step, cost and duel are H1
(csrc/track_coeffs.cu; tests/test_torch_cuda.py holds it to the plain
chain on the card). Here: CPU tensors take the plain chain, bit for bit and
with no kernel loaded or counted, and H1's launchers refuse what they do
not take before they load the library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu import synthetic as jsyn
from badslam_tpu.geometry import se3 as jse3
from badslam_tpu.geometry.camera import PinholeCamera
from badslam_tpu.ops.pyramid import build_pyramid
from badslam_tpu.tracking import pairwise as jpw
from badslam_torch import synthetic as tsyn
from badslam_torch.convert import camera_from_numpy, pose_from_numpy, pyramid_from_numpy
from badslam_torch.ops import kernels
from badslam_torch.ops.conditional import HOST, loop
from badslam_torch.tracking import pairwise as tpw

torch.set_num_threads(1)

NUM_SCALES = 4


# The cameras of the golden cases: the tests' 160x120, and the ETH3D SLAM
# camera's intrinsics scaled by 73/739 (slam_bench/tests/data/tiny_eth3d.json),
# where every pyramid level drops a column or a row: 73x45, 36x22, 18x11, 9x5.
CAMERAS = {
    "160x120": jsyn.default_camera(160, 120),
    "eth3d_73x45": PinholeCamera(fx=71.7455, fy=71.7455, cx=35.0775, cy=18.4723, width=73,
                                 height=45),
}


def _pair(seed, gt_motion, num_planes, camera="160x120"):
    rng = np.random.default_rng(seed)
    cam = CAMERAS[camera]
    scene = jsyn.random_plane_scene(rng, num_planes)
    d0, i0 = jsyn.render_scene(cam, scene, jse3.identity())
    d1, i1 = jsyn.render_scene(cam, scene, gt_motion)
    f0 = jsyn.frame_from_render(cam, d0, i0)
    f1 = jsyn.frame_from_render(cam, d1, i1)
    cams = tuple(cam.pyramid_level(i) for i in range(NUM_SCALES))
    p0 = build_pyramid(f0.depth, f0.nx, f0.ny, f0.intensity, NUM_SCALES)
    p1 = build_pyramid(f1.depth, f1.nx, f1.ny, f1.intensity, NUM_SCALES)
    tcams = tuple(camera_from_numpy(c) for c in cams)
    return (cams, p0, p1), (tcams, pyramid_from_numpy(p0, "cpu"),
                            pyramid_from_numpy(p1, "cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("use_desc", [False, True], ids=["geometric", "geo+photometric"])
def test_accumulate_and_cost_match_jax(use_desc):
    gt = jsyn.pose(tx=0.01, ty=-0.008, tz=0.012, rx=0.004, rz=0.005)
    (cams, p0, p1), (tcams, t0, t1) = _pair(31, gt, 6)
    est = jsyn.pose(tx=0.006, ty=-0.004, tz=0.01, rz=0.003)
    tq, tt = pose_from_numpy(est.q, est.t, "cpu")
    for scale in (0, 2):
        args_j = (cams[scale], p0[scale], p1[scale], jnp.array(est.q),
                  jnp.array(est.t), float(2 ** scale), 40.0, True, use_desc)
        args_t = (tcams[scale], t0[scale], t1[scale], tq, tt,
                  float(2 ** scale), 40.0, True, use_desc)
        Hj, bj, nj = jpw.accumulate_pose_coeffs(*args_j)
        Ht, bt, nt = tpw.accumulate_pose_coeffs(*args_t)
        assert int(nt) == int(nj) > 100
        np.testing.assert_allclose(_np(Ht), _np(Hj), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(_np(bt), _np(bj), rtol=1e-4, atol=1e-3)
        cj, kj = jpw.compute_cost_and_count(*args_j)
        ct, kt = tpw.compute_cost_and_count(*args_t)
        assert int(kt) == int(kj)
        np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)


@pytest.mark.parametrize("use_desc, camera", [
    pytest.param(False, "160x120", id="geometric"),
    pytest.param(True, "160x120", id="geo+photometric"),
    pytest.param(False, "eth3d_73x45", id="eth3d_73x45-geometric"),
    pytest.param(True, "eth3d_73x45", id="eth3d_73x45-geo+photometric")])
def test_track_frame_pairwise_with_duel_matches_jax(use_desc, camera):
    gt = jsyn.pose(tx=0.02, ty=-0.01, tz=0.012, rx=0.004, rz=0.01)
    (cams, p0, p1), (tcams, t0, t1) = _pair(33, gt, 3 if use_desc else 8, camera)
    assert [(c.width, c.height) for c in tcams][-1] == (
        (20, 15) if camera == "160x120" else (9, 5))
    bad = jsyn.pose(tx=-0.3, ty=0.2)
    jr = jpw.track_frame_pairwise(
        cams, p0, p1, bad.q, bad.t, gt.q, gt.t,
        use_descriptor=use_desc, test_two_initial_estimates=True)
    bq, bt = pose_from_numpy(bad.q, bad.t, "cpu")
    gq, gt_t = pose_from_numpy(gt.q, gt.t, "cpu")
    tr = tpw.track_frame_pairwise(
        tcams, t0, t1, bq, bt, gq, gt_t,
        use_descriptor=use_desc, test_two_initial_estimates=True)
    np.testing.assert_allclose(_np(tr.q), _np(jr.q), atol=1e-4)
    np.testing.assert_allclose(_np(tr.t), _np(jr.t), atol=1e-4)
    assert int(tr.residual_count) == int(jr.residual_count)
    assert tr.converged == bool(jr.converged)
    # And it tracked: the duel rejected the bad start.
    err = jse3.log(jse3.mul(jse3.inverse(jse3.SE3(jnp.array(_np(tr.q)),
                                                   jnp.array(_np(tr.t)))), gt))
    assert float(jnp.linalg.norm(err)) < 2e-3


def test_track_frame_pairwise_gradmag_matches_jax():
    gt = jsyn.pose(tx=0.012, ty=-0.006, rz=0.004)
    rng = np.random.default_rng(41)
    cam = jsyn.default_camera(160, 120)
    scene = jsyn.random_plane_scene(rng, 4)
    frames = [jsyn.frame_from_render(cam, *jsyn.render_scene(cam, scene, p))
              for p in (jse3.identity(), gt)]
    pyrs = [build_pyramid(f.depth, f.nx, f.ny, f.intensity, NUM_SCALES, gradmag=True)
            for f in frames]
    cams = tuple(cam.pyramid_level(i) for i in range(NUM_SCALES))
    I = jse3.identity()
    jr = jpw.track_frame_pairwise(cams, *pyrs, I.q, I.t, I.q, I.t,
                                  use_descriptor=False, use_gradmag=True)
    ident = pose_from_numpy(np.asarray(I.q), np.asarray(I.t), "cpu")
    tr = tpw.track_frame_pairwise(
        tuple(camera_from_numpy(c) for c in cams),
        *(pyramid_from_numpy(p, "cpu") for p in pyrs),
        *ident, *ident, use_descriptor=False, use_gradmag=True)
    np.testing.assert_allclose(_np(tr.q), _np(jr.q), atol=1e-4)
    np.testing.assert_allclose(_np(tr.t), _np(jr.t), atol=1e-4)


def test_tracking_empty_frames_returns_initial():
    cam = camera_from_numpy(jsyn.default_camera(160, 120))
    cams = tuple(cam.pyramid_level(i) for i in range(NUM_SCALES))
    zero = torch.zeros((120, 160))
    from badslam_torch.ops.pyramid import build_pyramid as tbuild

    p = tbuild(zero, zero, zero, zero, NUM_SCALES)
    init = jsyn.pose(tx=0.05)
    q, t = pose_from_numpy(init.q, init.t, "cpu")
    res = tpw.track_frame_pairwise(cams, p, p, q, t, q, t)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(init.t))
    assert torch.all(torch.isfinite(res.q))
    assert int(res.residual_count) == 0


def _port_pair(gradmag=False):
    """A rendered 64x48 pair on the CPU (badslam_torch.synthetic) and an
    estimate off its motion: the arguments of accumulate_pose_coeffs at
    level 1."""
    cams, base, tracked, (q, t) = tsyn.tracking_pair(
        tsyn.default_camera(64, 48), 5, "cpu", num_scales=3, gradmag=gradmag)
    q = q + torch.tensor([0.0, 0.001, -0.0015, 0.0005])
    q = q / torch.linalg.vector_norm(q)
    t = t + torch.tensor([0.004, 0.003, -0.005])
    return (cams[1], base[1], tracked[1], q, t, 2.0, 40.0, True, not gradmag, gradmag)


@pytest.fixture
def no_library(monkeypatch):
    """Fails any test that loads a kernel library."""
    def refuse(source):
        raise AssertionError(f"{source} was loaded")
    monkeypatch.setattr(kernels, "_library", refuse)


@pytest.mark.parametrize("gradmag", [False, True], ids=["depth+descriptor", "gradmag"])
def test_cpu_tensors_take_the_plain_chain(no_library, gradmag):
    """On CPU tensors the dispatching entry points are the plain chains, bit
    for bit, and count no H1 launch."""
    args = _port_pair(gradmag)
    cam, base, tracked, q, t, s, bfx, *flags = args
    before = dict(kernels.launch_counts)
    for got, want in (
            (tpw.accumulate_pose_coeffs(*args), tpw.accumulate_pose_coeffs_plain(*args)),
            (tpw.compute_cost_and_count(*args), tpw.compute_cost_and_count_plain(*args)),
            (tpw._gn_step(cam, base, tracked, q, t, s, 0.5, bfx, *flags),
             tpw._gn_step_plain(cam, base, tracked, q, t, s, 0.5, bfx, *flags)),
            (tpw._duel(cam, base, tracked, q, t, q, t + 0.01, s, bfx, *flags),
             tpw._duel_plain(cam, base, tracked, q, t, q, t + 0.01, s, bfx, *flags))):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert int(tpw.accumulate_pose_coeffs(*args)[2]) > 100
    assert kernels.launch_counts == before


def _bad_inputs(case):
    """H1 launcher arguments with one fault each (CPU tensors everywhere)."""
    cam, base, tracked, q, t, s, bfx, *flags = _port_pair()
    if case == "float64 plane":
        base = base._replace(ny=base.ny.double())
    elif case == "plane shapes differ":
        tracked = tracked._replace(depth=tracked.depth[:-1])
    elif case == "quaternion of 3":
        q = q[:3]
    elif case == "batched planes":
        base = base._replace(depth=base.depth[None])
    return cam, base, tracked, q, t, s, bfx, flags


@pytest.mark.parametrize("case", ["cpu tensors", "float64 plane", "plane shapes differ",
                                  "quaternion of 3", "batched planes"])
def test_track_launchers_refuse_before_loading(no_library, case):
    """Each H1 launcher raises ValueError on CPU tensors, another dtype, planes
    of two shapes or a pose of the wrong size, before it loads the
    library (as gather_cuda does)."""
    cam, base, tracked, q, t, s, bfx, flags = _bad_inputs(case)
    match = {"cpu tensors": "CUDA", "batched planes": r"\[H, W\]"}.get(case, "float32")
    with pytest.raises(ValueError, match=match):
        kernels.track_coeffs_cuda(cam, base, tracked, q, t, s, bfx, *flags)
    with pytest.raises(ValueError, match=match):
        kernels.track_cost_cuda(cam, base, tracked, [(q, t), (q, t)], s, bfx, *flags)
    with pytest.raises(ValueError, match=match):
        kernels.track_step_cuda(cam, base, tracked, q, t, s, 1.0, 1e-8, bfx, *flags, q, t,
                                torch.zeros((), dtype=torch.bool))


def test_loop_refuses_step_in_place_with_a_limit():
    """The tracker's in-place WHILE body takes the host bound `most`: the
    shared loop refuses it beside a device `limit` rather than run the
    generic body in its stead."""
    state = (torch.zeros(()),)
    with pytest.raises(ValueError, match="step_in_place"):
        loop(HOST, state, lambda s: s[0] < 1, lambda s: (s[0] + 1,), most=3,
             limit=torch.tensor(2), step_in_place=lambda *a: None)


def test_build_digest_covers_included_headers(tmp_path, monkeypatch):
    """A kernel library's name hashes the headers its source includes from
    csrc/ (H1, H2 and H3 share gn_sums.cuh): an edit to a header alone, nested
    ones too, names a new library, so no stale build is loaded; an
    unrelated file changes nothing."""
    monkeypatch.setattr(kernels, "_CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include <math.h>\n#include "a.cuh"\nint f();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("constexpr int kN = 1;\n")
    (tmp_path / "c.cuh").write_text("constexpr int kM = 1;\n")
    first = kernels._digest("k.cu")
    (tmp_path / "c.cuh").write_text("constexpr int kM = 2;\n")
    assert kernels._digest("k.cu") == first
    (tmp_path / "b.cuh").write_text("constexpr int kN = 2;\n")
    second = kernels._digest("k.cu")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// edited\n')
    assert kernels._digest("k.cu") not in (first, second)


def test_library_digests_cover_the_shared_headers():
    """H2 and H3 include association.cuh, which includes gn_sums.cuh (H1's
    too): an edit to either names new libraries for its includers alone."""
    assert kernels._sources_hashed("pose_coeffs.cu") == [
        "pose_coeffs.cu", "association.cuh", "gn_sums.cuh"]
    assert kernels._sources_hashed("geometry_coeffs.cu") == [
        "geometry_coeffs.cu", "association.cuh", "gn_sums.cuh"]
    assert kernels._sources_hashed("track_coeffs.cu") == ["track_coeffs.cu", "gn_sums.cuh"]
    assert kernels._sources_hashed("gather.cu") == ["gather.cu"]
