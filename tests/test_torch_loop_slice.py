"""The front end's loop closure in the port against the JAX package's, and
the default configuration end to end.

Tolerances:
  * the injected closure of test_loop.py:211 (both packages on the same
    dataset, the same drift, the JAX package's OpenCV features fed to the
    port's detector so that the necessity gate sees the same keypoints):
    keyframe poses and the trajectory within 1e-4, the closure count and
    the gate decisions equal; a rejected candidate leaves every pose of the
    port bit-identical;
  * a run resumed from a snapshot taken after a closure: poses within 1e-4
    of the continuous run, the same closure count;
  * the default flags (loop detection on, on the worker thread) on a
    sequence with no candidate: poses identical to loop detection off;
  * the worker thread applies each closure one keyframe after the
    synchronous path, at the same frames whatever the timing.
"""

import numpy as np
import pytest
import torch

from badslam_torch import synthetic as tsyn
from badslam_torch.cli import run as torch_run
from badslam_torch.config import BadSlamConfig as TConfig
from badslam_torch.frontend import BadSlam
from badslam_torch.geometry import se3 as tse3
from badslam_torch.geometry import se3_np as ts3
from badslam_torch.io import dataset as tds
from badslam_torch.io import state as tstate
from badslam_torch.loop import detector as tdetector
from badslam_torch.loop import features as tfeatures

torch.set_num_threads(1)

CFG = dict(num_scales=3, max_surfel_count=1 << 13, keyframe_interval=4,
           max_num_ba_iterations_per_keyframe=0, enable_loop_detection=True)
DRIFT = tsyn.pose(tx=0.004, ty=-0.003, rz=0.002)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """test_loop.py:211's dataset: 16 frames at 128x96."""
    path = str(tmp_path_factory.mktemp("loop") / "ds")
    tsyn.write_tum_dataset(path, tsyn.default_camera(128, 96),
                           tsyn.random_plane_scene(np.random.default_rng(3), 6),
                           tsyn.smooth_trajectory(16, scale=0.006))
    return path


def _host(q, t):
    return ts3.SE3(np.asarray(q, float), np.asarray(t, float))


def _inject_drift(ks, slot, to_device):
    """Moves keyframe `slot` by DRIFT; returns its true (host) pose."""
    true = _host(np.asarray(ks.q[slot]), np.asarray(ks.t[slot]))
    moved = ts3.mul(_host(DRIFT.q, DRIFT.t), true)
    ks.set_pose(slot, to_device(moved))
    return true


def _port_pose(p):
    return tse3.SE3(torch.tensor(p.q, dtype=torch.float32), torch.tensor(p.t, dtype=torch.float32))


def test_injected_closure_matches_jax(sequence, monkeypatch):
    pytest.importorskip("cv2")
    import jax.numpy as jnp

    from badslam_tpu.config import BadSlamConfig as JConfig
    from badslam_tpu.frontend import BadSlam as JBadSlam
    from badslam_tpu.geometry import se3 as jse3
    from badslam_tpu.io.dataset import load_tum_dataset as jload
    from badslam_tpu.loop import features as jfeatures

    def jax_extract(gray, depth, cam, max_features=500):
        return tfeatures.KeyframeFeatures(*jfeatures.extract_features(gray, depth, cam, max_features))

    monkeypatch.setattr(tdetector, "extract_features", jax_extract)

    jslam = JBadSlam(JConfig(**CFG), jload(sequence))
    jslam.run(progress=False)
    tslam = BadSlam(TConfig(**CFG), tds.load_tum_dataset(sequence), "cpu")
    tslam.run()
    jks, tks = jslam.direct_ba.keyframes, tslam.direct_ba.keyframes
    last = tks.count - 1
    assert jks.count == tks.count == 4
    np.testing.assert_allclose(tks.t.numpy()[:4], np.asarray(jks.t)[:4], atol=1e-4, rtol=0)
    for j, t in zip(jslam.loop_detector.features[last], tslam.loop_detector.features[last]):
        np.testing.assert_array_equal(t, j)

    # The JAX package's keyframe poses are the inputs of both.
    true = _host(np.asarray(jks.q[last]), np.asarray(jks.t[last]))
    matched = _host(np.asarray(jks.q[0]), np.asarray(jks.t[0]))
    cur_T_matched = ts3.mul(ts3.inverse(true), matched)
    tks.q[:4] = torch.tensor(np.asarray(jks.q)[:4])
    tks.t[:4] = torch.tensor(np.asarray(jks.t)[:4])
    tslam.traj_q[:] = torch.tensor(np.asarray(jslam.traj_q))
    tslam.traj_t[:] = torch.tensor(np.asarray(jslam.traj_t))

    # The keyframe has fewer than 5 keypoints here, so the necessity gate
    # passes whatever the motion. With 40 keypoints and no drift the closure
    # would move them by under a pixel: the gate rejects it in both
    # packages, and nothing moves.
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-0.5, 0.5, 40), rng.uniform(-0.4, 0.4, 40),
                    rng.uniform(1.0, 2.0, 40)], -1).astype(np.float32)
    own = (tslam.loop_detector.features[last], jslam.loop_detector.features[last])
    assert len(own[0].points_local) < 5
    tslam.loop_detector.features[last] = own[0]._replace(points_local=pts)
    jslam.loop_detector.features[last] = own[1]._replace(points_local=pts)
    kq, kt, tq, tt = (x.clone() for x in (tks.q, tks.t, tslam.traj_q, tslam.traj_t))
    tslam._attempt_loop_closure(last, 0, cur_T_matched)
    jslam._attempt_loop_closure(last, 0, cur_T_matched)
    assert tslam.closure_attempts[-1]["consistent"] and not tslam.closure_attempts[-1]["needed"]
    assert tslam.loop_closure_count == jslam.loop_closure_count == 0
    for a, b in ((kq, tks.q), (kt, tks.t), (tq, tslam.traj_q), (tt, tslam.traj_t)):
        assert torch.equal(a, b)
    tslam.loop_detector.features[last], jslam.loop_detector.features[last] = own

    def to_jax(p):
        return jse3.SE3(jnp.asarray(p.q, jnp.float32), jnp.asarray(p.t, jnp.float32))

    jks.set_pose(last, to_jax(ts3.mul(_host(DRIFT.q, DRIFT.t), true)))
    tks.set_pose(last, _port_pose(ts3.mul(_host(DRIFT.q, DRIFT.t), true)))
    before = np.linalg.norm(tks.t[last].numpy() - true.t)
    assert before > 2e-3
    tslam._attempt_loop_closure(last, 0, cur_T_matched)
    jslam._attempt_loop_closure(last, 0, cur_T_matched)
    assert tslam.loop_closure_count == jslam.loop_closure_count == 1
    assert tslam.closure_attempts[-1] == dict(frame=15, kf=last, matched=0, refinements=2,
                                              consistent=True, needed=True)
    np.testing.assert_allclose(tks.q.numpy()[:4], np.asarray(jks.q)[:4], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tks.t.numpy()[:4], np.asarray(jks.t)[:4], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tslam.traj_q.numpy(), np.asarray(jslam.traj_q), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tslam.traj_t.numpy(), np.asarray(jslam.traj_t), atol=1e-4, rtol=0)
    after = np.linalg.norm(tks.t[last].numpy() - true.t)
    assert after < 0.5 * before, (before, after)
    np.testing.assert_array_equal(tslam.base_kf_global_T_frame.t.numpy(), tks.t[last].numpy())
    jslam.close()
    tslam.close()


def test_resume_after_a_closure_matches_continuous_run(sequence, tmp_path):
    """Frames 0-11, a closure of keyframe 2 onto keyframe 0 (drift
    injected), a snapshot; then frames 12-15 continuously and resumed."""
    cfg = TConfig(**CFG)
    slam = BadSlam(cfg, tds.load_tum_dataset(sequence), "cpu")
    slam.run(end=12)
    ks = slam.direct_ba.keyframes
    true = _inject_drift(ks, 2, _port_pose)
    matched = _host(ks.q[0].numpy(), ks.t[0].numpy())
    slam._attempt_loop_closure(2, 0, ts3.mul(ts3.inverse(true), matched))
    assert slam.loop_closure_count == 1
    snap = str(tmp_path / "snap.npz")
    tstate.save_state(slam, snap)
    slam.run(start=12)
    resumed = tstate.load_state(snap, tds.load_tum_dataset(sequence), "cpu")
    assert resumed.loop_closure_count == 1
    resumed.run(start=resumed.last_frame_index + 1)
    np.testing.assert_allclose(resumed.traj_t.numpy(), slam.traj_t.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(resumed.traj_q.numpy(), slam.traj_q.numpy(), atol=1e-4, rtol=0)
    assert resumed.loop_closure_count == slam.loop_closure_count == 1
    assert resumed.loop_detector._order == slam.loop_detector._order == [0, 1, 2, 3]
    slam.close()
    resumed.close()


def test_default_flags_run_loop_detection(tmp_path):
    """python -m badslam_torch with default flags on a 24-frame 64x48
    sequence that offers no candidate: the same poses as without loop
    detection."""
    data = str(tmp_path / "seq")
    tsyn.write_tum_dataset(data, tsyn.default_camera(64, 48),
                           tsyn.random_plane_scene(np.random.default_rng(5), 6),
                           tsyn.smooth_trajectory(24))
    on = torch_run([data, "--device", "cpu", "--quiet"])
    off = torch_run([data, "--device", "cpu", "--quiet", "--enable_loop_detection", "false"])
    assert on.loop_detector is not None and on._loop_thread is None  # closed by the CLI
    assert len(on.loop_detector.features) == 3 and on.closure_attempts == []
    assert off.loop_detector is None
    assert torch.equal(on.traj_q, off.traj_q) and torch.equal(on.traj_t, off.traj_t)


@pytest.mark.parametrize("parallel", [False, True], ids=["sync", "thread"])
def test_closures_land_at_fixed_frames(tmp_path, monkeypatch, parallel):
    """Candidates at keyframes 2 and 4 (frames 6 and 12 of 13, a keyframe
    every 3): the synchronous path attempts them at frames 6 and 12, the
    worker thread one keyframe later (frame 9) and, for the last keyframe,
    at the end of the run."""
    data = str(tmp_path / "seq")
    tsyn.write_tum_dataset(data, tsyn.default_camera(64, 48),
                           tsyn.random_plane_scene(np.random.default_rng(5), 6),
                           tsyn.smooth_trajectory(13))
    monkeypatch.setattr(tdetector.LoopDetector, "_detect_candidate",
                        lambda self, kf: {2: 0, 4: 1}.get(kf))
    monkeypatch.setattr(tdetector.LoopDetector, "_initial_alignment",
                        lambda self, cur, old, rng: (ts3.identity(), 30))
    seen = []
    monkeypatch.setattr(BadSlam, "_attempt_loop_closure",
                        lambda self, kf, m, init: seen.append((self.last_frame_index, kf, m)))
    cfg = TConfig(num_scales=2, keyframe_interval=3, max_num_ba_iterations_per_keyframe=0,
                  fps_restriction=0, loop_closure_cooldown_keyframes=0,
                  parallel_loop_detection=parallel)
    slam = BadSlam(cfg, tds.load_tum_dataset(data), "cpu")
    slam.run()
    slam.close()
    assert seen == ([(9, 2, 0), (12, 4, 1)] if parallel else [(6, 2, 0), (12, 4, 1)])


@pytest.mark.slow
def test_organic_loop_closure(tmp_path):
    """test_loop_organic.py in the port, with its own extractor: 170 frames
    at 128x96 revisiting a textured room, the default pipeline (loop
    detection on the worker thread, parallel BA, a keyframe every 10
    frames), with loop detection on and off."""
    W, H, frames, loop = 128, 96, 170, 150
    path = str(tmp_path / "loop_ds")
    gt = tsyn.loop_trajectory(frames, loop_frames=loop, orbit_radius=0.4)
    tsyn.write_tum_dataset(path, tsyn.default_camera(W, H), tsyn.room_scene(3.5), gt,
                           albedo=lambda p: tsyn.textured_intensity_at(p, cell=0.07),
                           depth_noise=0.004, depth_bias_quadratic=0.004, intensity_noise=2.0)

    def run(loop_on):
        cfg = TConfig(num_scales=3, max_surfel_count=1 << 15, max_depth=3.5,
                      enable_loop_detection=loop_on, loop_detection_image_frequency=0.3,
                      loop_detection_images_width=W, loop_detection_images_height=H,
                      fps_restriction=0)
        video = tds.load_tum_dataset(path)
        slam = BadSlam(cfg, video, "cpu")
        early = None
        for i in range(frames):
            slam.process_frame(i)
            video.clear_frame(i)
            if i == loop - 1:
                early = slam.loop_closure_count
        slam._drain_loop_detections()
        slam.close()
        q, t = slam.traj_q.numpy(), slam.traj_t.numpy()
        est = [tsyn.SE3(q[i], t[i]) for i in range(frames)]
        return tsyn.ate_rmse(est, gt), slam.loop_closure_count, early, est

    ate_on, closures, early, est = run(True)
    ate_off = run(False)[0]
    assert closures >= 1 and early == 0
    assert ate_on < 0.66 * ate_off, (ate_on, ate_off)

    def rel(a, b):
        return ts3.mul(ts3.inverse(_host(a.q, a.t)), _host(b.q, b.t))

    err = ts3.log(ts3.mul(ts3.inverse(rel(gt[0], gt[-1])), rel(est[0], est[-1])))
    print(f"organic loop at {W}x{H}: closures {closures}, ATE on {ate_on:.4f} m, off "
          f"{ate_off:.4f} m, endpoint error {np.linalg.norm(err[:3]):.4f} m")
    assert np.linalg.norm(err[:3]) < 0.6, err
