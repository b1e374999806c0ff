"""The port's state snapshots, calibration files, fixed-window BA and final
BA against the JAX package.

Tolerances:
  * keyframe activation after a fixed window: exact; one windowed BA call:
    poses atol 1e-4, surfel counts, activation states and iterations exact
    (tests/test_torch_ba.py's holds for a BA call);
  * snapshots interchange: a JAX snapshot loads into the port with the
    same surfel and keyframe counts and parallel-BA queue, and the port's
    resumed run holds to JAX's resumed run at 1e-4 (poses); a port
    snapshot loads into the JAX package with the same counts;
  * the port resumed from its own snapshot against its continuous run:
    poses within 1e-6 (the same float32 operations in the same order);
  * calibration files: exact round trips (1e-9 on the text's floats);
  * CLI against CLI with the median filter and the final BA: poses 1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch

from badslam_tpu import synthetic as jsyn
from badslam_tpu.cli import main as jax_main
from badslam_tpu.config import BadSlamConfig as JConfig
from badslam_tpu.frontend import BadSlam as JBadSlam
from badslam_tpu.io import dataset as jds
from badslam_tpu.io import state as jstate
from badslam_torch import convert
from badslam_torch import synthetic as tsyn
from badslam_torch.cli import main as torch_main
from badslam_torch.config import BadSlamConfig as TConfig
from badslam_torch.io import dataset as tds
from badslam_torch.io import state as tstate
from badslam_torch.mapping import keyframes as tkfs

from test_torch_ba import assert_poses_close, two_keyframes
from test_torch_mapping import DEV

torch.set_num_threads(1)

POSE_ATOL = 1e-4
CLI_FLAGS = ["--enable_loop_detection", "false", "--fps_restriction", "0",
             "--max_surfel_count", str(1 << 13), "--quiet"]
STATE_CFG = dict(num_scales=2, max_surfel_count=1 << 12, keyframe_interval=4,
                 enable_loop_detection=False, fps_restriction=0)
FRAMES = 12


def _trajectory(path):
    _, poses = tds.load_tum_trajectory(path)
    return (np.stack([p.q for p in poses]).astype(np.float64),
            np.stack([p.t for p in poses]).astype(np.float64))


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A 64x48 sequence of 12 frames, and a copy of its first 5 frames
    (listed from the same image files)."""
    root = tmp_path_factory.mktemp("state")
    data = str(root / "seq")
    gt = tsyn.smooth_trajectory(FRAMES)
    tsyn.write_tum_dataset(data, tsyn.default_camera(64, 48),
                           tsyn.random_plane_scene(np.random.default_rng(7), 5), gt)
    half = str(root / "half")
    os.makedirs(half)
    with open(os.path.join(data, "associated.txt")) as f:
        rows = [line.split() for line in f if line.strip()][:5]
    with open(os.path.join(half, "associated.txt"), "w") as f:
        f.writelines(f"{a} ../seq/{b} {c} ../seq/{d}\n" for a, b, c, d in rows)
    with open(os.path.join(data, "calibration.txt")) as src, \
            open(os.path.join(half, "calibration.txt"), "w") as dst:
        dst.write(src.read())
    return data, half, gt


def test_activation_window_matches_jax():
    p, kf0, kf1 = two_keyframes(11)
    for lo, hi in ((0, 0), (1, 1), (0, 1), (1, 5)):
        p.j.keyframes.set_activation_window(lo, hi)
        p.j.keyframes.propagate_covisible_active()
        p.t.keyframes.set_activation_window(lo, hi)
        p.t.keyframes.propagate_covisible_active()
        np.testing.assert_array_equal(p.t.keyframes.activation[:2].numpy(),
                                      np.asarray(p.j.keyframes.activation)[:2])
    assert int(p.t.keyframes.activation[kf1]) == tkfs.ACTIVE


def test_windowed_bundle_adjustment_matches_jax():
    """One final-BA window: keyframe 1 active, keyframe 0 covisible; every
    iteration runs (no early exit) in both packages."""
    p, kf0, kf1 = two_keyframes(13)
    iters_j = p.j.bundle_adjustment(max_iterations=3, active_keyframe_window=(1, 1))
    iters_t = p.t.bundle_adjustment(max_iterations=3, active_keyframe_window=(1, 1))
    assert iters_t == iters_j == 3
    assert_poses_close(p.t.keyframes, p.j.keyframes)
    assert p.t.surfel_count == p.j.surfel_count > 500
    assert p.t.ba_iteration_count == p.j.ba_iteration_count == 1
    np.testing.assert_array_equal(p.t.keyframes.activation[:2].numpy(),
                                  np.asarray(p.j.keyframes.activation)[:2])


def _radtan_cli_pair(tmp_path, median_passes):
    """A 96x72 radtan sequence (seed 3) through both CLIs with BA at every
    3rd frame and the final BA (windows of 2 keyframes, stride 1), with
    `median_passes` median passes; poses held at 1e-4. Returns the ATE of
    the port and of the JAX package and the port's frame-times summary."""
    data = str(tmp_path / "seq")
    gt = tsyn.smooth_trajectory(8)
    tsyn.write_tum_dataset(data, tsyn.default_camera(96, 72),
                           tsyn.random_plane_scene(np.random.default_rng(3), 5), gt,
                           distortion=(-0.06, 0.01))
    flags = ["--num_scales", "3", "--keyframe_interval", "3",
             "--max_num_ba_iterations_per_keyframe", "4",
             "--median_filter_and_densify_iterations", str(median_passes), "--final_ba",
             "--final_ba_window_size", "2", "--final_ba_window_stride", "1", *CLI_FLAGS]
    out = {k: str(tmp_path / f"{k}.txt") for k in ("jax", "torch")}
    times = str(tmp_path / "times.json")
    assert jax_main([data, *flags, "--export_poses", out["jax"]]) == 0
    assert torch_main([data, "--device", "cpu", *flags, "--export_poses", out["torch"],
                       "--export_frame_times", times]) == 0
    (qj, tj), (qt, tt) = _trajectory(out["jax"]), _trajectory(out["torch"])
    assert len(qt) == len(qj) == 8
    np.testing.assert_allclose(tt, tj, atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(qt, qj, atol=POSE_ATOL, rtol=0)
    ate = [tsyn.ate_rmse([tds.SE3(q, t) for q, t in zip(qs, ts)], gt)
           for qs, ts in ((qt, tt), (qj, tj))]
    print(f"96x72 radtan, {median_passes} median passes: ATE port {ate[0]:.4e} m, "
          f"JAX {ate[1]:.4e} m")
    with open(times) as f:
        return ate[0], ate[1], json.load(f)


def test_radtan_median_final_ba_cli_matches_jax_cli(tmp_path):
    """Two median passes. The scene (seed 3) is one the tracker follows; on
    one it loses (seed 9, ATE 1.5e-2 m) float-order differences grow to
    ~5e-5 m."""
    ate_t, ate_j, summary = _radtan_cli_pair(tmp_path, 2)
    assert abs(ate_t - ate_j) < 1e-5 and ate_j < 3e-3
    # Keyframes 0, 3, 6: windows (0, 1), (1, 2), then all three, 10 each.
    assert summary["final_ba_iterations"] == summary["ba_iterations"][-3:] == [10, 10, 10]
    assert summary["final_ba_s"] > 0


def test_radtan_final_ba_cli_without_median_matches_jax_cli(tmp_path):
    """The same sequence without the median: what undistortion alone costs
    in the JAX package, and that the port's ATE is the same."""
    ate_t, ate_j, _ = _radtan_cli_pair(tmp_path, 0)
    assert abs(ate_t - ate_j) < 1e-5


def _jax_slam(data, end, **cfg):
    slam = JBadSlam(JConfig(**STATE_CFG, **cfg), jds.load_tum_dataset(data))
    slam.run(start=0, end=end)
    return slam


def test_jax_snapshot_resumes_in_the_port(sequence, tmp_path):
    """A JAX snapshot with parallel-BA work queued, resumed by both
    packages over the rest of the sequence."""
    data, _, gt = sequence
    snap = str(tmp_path / "jax.npz")
    jslam = _jax_slam(data, 6)
    jstate.save_state(jslam, snap)
    assert jslam.queued_ba_iterations > 0

    tslam = tstate.load_state(snap, tds.load_tum_dataset(data), "cpu")
    assert tslam.last_frame_index == 5
    assert tslam.queued_ba_iterations == jslam.queued_ba_iterations
    assert tslam.bundle_adjustment_counter == jslam.bundle_adjustment_counter
    assert tslam.direct_ba.ba_iteration_count == jslam.direct_ba.ba_iteration_count
    assert tslam.direct_ba.surfel_count == int(jslam.direct_ba.surfels.count) > 100
    assert tslam.direct_ba.keyframes.count == jslam.direct_ba.keyframes.count == 2
    assert tslam._hist_n == min(jslam._hist_n, 3)
    np.testing.assert_array_equal(tslam.traj_t.numpy(), np.asarray(jslam.traj_t))

    jres = jstate.load_state(snap, jds.load_tum_dataset(data))
    jres.run(start=jres.last_frame_index + 1)
    tslam.run(start=tslam.last_frame_index + 1)
    np.testing.assert_allclose(tslam.traj_t.numpy(), np.asarray(jres.traj_t), atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(tslam.traj_q.numpy(), np.asarray(jres.traj_q), atol=POSE_ATOL, rtol=0)
    assert tslam.has_pose.all() and jres.has_pose.all()
    n_t, n_j = tslam.direct_ba.surfel_count, int(jres.direct_ba.surfels.count)
    assert abs(n_t - n_j) <= 0.01 * n_j
    poses = [tds.SE3(q, t) for q, t in zip(tslam.traj_q.numpy(), tslam.traj_t.numpy())]
    assert tsyn.ate_rmse(poses, gt) < 2e-3


def test_port_snapshot_loads_in_jax(sequence, tmp_path):
    data, _, _ = sequence
    snap = str(tmp_path / "torch.npz")
    from badslam_torch.frontend import BadSlam

    tslam = BadSlam(TConfig(**STATE_CFG), tds.load_tum_dataset(data), "cpu")
    tslam.run(start=0, end=6)
    tstate.save_state(tslam, snap)
    z = np.load(snap)
    jz = {"kf_activation": np.int32, "kf_last_active_iter": np.int32, "sf_count": np.int32,
          "kf_covis": bool, "cam": np.float64, "frame_poses_q": np.float32}
    for key, dtype in jz.items():
        assert z[key].dtype == dtype, key

    jslam = jstate.load_state(snap, jds.load_tum_dataset(data))
    assert int(jslam.direct_ba.surfels.count) == tslam.direct_ba.surfel_count > 100
    assert jslam.direct_ba.keyframes.count == tslam.direct_ba.keyframes.count == 2
    assert jslam.queued_ba_iterations == tslam.queued_ba_iterations > 0
    assert jslam.last_frame_index == 5
    np.testing.assert_array_equal(np.asarray(jslam.traj_q), tslam.traj_q.numpy())
    np.testing.assert_array_equal(np.asarray(jslam.base_kf_global_T_frame.t),
                                  tslam.base_kf_global_T_frame.t.numpy())
    # The port reads its own snapshot back to the same state.
    back = tstate.load_state(snap, tds.load_tum_dataset(data), "cpu")
    assert back.direct_ba.surfel_count == tslam.direct_ba.surfel_count
    for name in ("pos", "normal", "desc", "valid"):
        n = tslam.direct_ba.surfels.capacity
        assert torch.equal(getattr(back.direct_ba.surfels, name)[:n],
                           getattr(tslam.direct_ba.surfels, name))

    def edited(name, **config):
        d = dict(z, loop_closure_count=np.int64(3))
        d["config_json"] = json.dumps({**json.loads(str(z["config_json"])), **config})
        np.savez_compressed(str(tmp_path / name), **d)
        return str(tmp_path / name)

    # A snapshot whose config enables loop detection loads with its closure
    # count, and the live keyframes are registered with the detector through
    # the worker thread, in temporal order.
    loop = tstate.load_state(edited("loop.npz", enable_loop_detection=True),
                             tds.load_tum_dataset(data), "cpu")
    loop._drain_loop_detections()
    assert loop.loop_closure_count == 3
    assert loop.loop_detector._order == loop.direct_ba.keyframes.live_slots_in_time_order()
    assert all(len(f.descriptors) > 0 for f in loop.loop_detector.features.values())
    loop.close()
    # One that asks for several devices loads with a mesh of that many
    # shards, in both packages.
    mesh_snap = edited("mesh.npz", n_devices=2)
    on_mesh = tstate.load_state(mesh_snap, tds.load_tum_dataset(data), "cpu")
    assert on_mesh.direct_ba.mesh.devices == (torch.device("cpu"),) * 2
    assert on_mesh.direct_ba.surfel_count == tslam.direct_ba.surfel_count
    jmesh = jstate.load_state(mesh_snap, jds.load_tum_dataset(data))
    assert jmesh.config.n_devices == 2
    assert int(jmesh.direct_ba.surfels.count) == tslam.direct_ba.surfel_count


def test_jax_mesh_snapshot_resumes_in_the_port(sequence, tmp_path):
    """A JAX snapshot taken with n_devices=2 (BA over two of its CPU
    devices) at the keyframe of frame 4, parallel-BA work queued, resumes
    in the port on a 2-shard CPU mesh and matches the continuous runs with
    n_devices=2 of both packages."""
    from badslam_torch.frontend import BadSlam

    data, _, gt = sequence
    snap = str(tmp_path / "jax_mesh.npz")
    jslam = _jax_slam(data, 5, n_devices=2)
    jstate.save_state(jslam, snap)
    assert jslam.queued_ba_iterations > 0

    tslam = tstate.load_state(snap, tds.load_tum_dataset(data), "cpu")
    assert tslam.direct_ba.mesh.size == 2
    assert tslam.direct_ba.surfel_count == int(jslam.direct_ba.surfels.count) > 100
    tslam.run(start=tslam.last_frame_index + 1)
    jcont = _jax_slam(data, FRAMES, n_devices=2)
    tcont = BadSlam(TConfig(**STATE_CFG, n_devices=2), tds.load_tum_dataset(data), "cpu")
    tcont.run()
    for q, t, n in ((np.asarray(jcont.traj_q), np.asarray(jcont.traj_t),
                     int(jcont.direct_ba.surfels.count)),
                    (tcont.traj_q.numpy(), tcont.traj_t.numpy(), tcont.direct_ba.surfel_count)):
        np.testing.assert_allclose(tslam.traj_t.numpy(), t, atol=POSE_ATOL, rtol=0)
        np.testing.assert_allclose(tslam.traj_q.numpy(), q, atol=POSE_ATOL, rtol=0)
        assert abs(tslam.direct_ba.surfel_count - n) <= 0.01 * n
    assert tslam.has_pose.all()
    poses = [tds.SE3(q, t) for q, t in zip(tslam.traj_q.numpy(), tslam.traj_t.numpy())]
    assert tsyn.ate_rmse(poses, gt) < 2e-3


def test_port_resume_matches_continuous_run(sequence, tmp_path):
    """Through the CLI: the first 5 frames with --save_state (a keyframe
    with queued BA at frame 4), then --load_state on the whole sequence,
    against one continuous run."""
    data, half, gt = sequence
    flags = ["--device", "cpu", "--num_scales", "2", "--keyframe_interval", "4",
             *CLI_FLAGS]
    snap, cont, resumed = (str(tmp_path / n) for n in ("s.npz", "cont.txt", "res.txt"))
    assert torch_main([half, *flags, "--save_state", snap]) == 0
    assert int(np.load(snap)["queued_ba_iterations"]) == 8
    assert torch_main([data, *flags, "--load_state", snap, "--export_poses", resumed]) == 0
    assert torch_main([data, *flags, "--export_poses", cont]) == 0
    (qr, tr), (qc, tc) = _trajectory(resumed), _trajectory(cont)
    assert len(qr) == len(qc) == FRAMES
    np.testing.assert_allclose(tr, tc, atol=1e-6, rtol=0)
    np.testing.assert_allclose(qr, qc, atol=1e-6, rtol=0)


def test_calibration_files_round_trip(tmp_path):
    from badslam_tpu.ba.intrinsics_opt import empty_depth_params as jparams
    from badslam_torch.ba.intrinsics_opt import DepthParams

    jcam = jsyn.default_camera(64, 48)
    tcam = convert.camera_from_numpy(jcam)
    cf = np.random.default_rng(1).uniform(-0.01, 0.01, (12, 16)).astype(np.float32)
    tp = DepthParams(a=torch.tensor(0.1), cfactor=torch.from_numpy(cf))
    jp = jparams(48, 64, 4)._replace(a=jparams(48, 64, 4).a + 0.1, cfactor=cf)
    tstate.save_calibration(tcam, tp, str(tmp_path / "t"))
    jstate.save_calibration(jcam, jp, str(tmp_path / "j"))
    for suffix in ("_depth_intrinsics.txt", "_color_intrinsics.txt", "_deformation.txt"):
        assert (tmp_path / f"t{suffix}").read_text() == (tmp_path / f"j{suffix}").read_text()
    for prefix in ("t", "j"):
        got_t = tstate.load_calibration(str(tmp_path / prefix))
        got_j = jstate.load_calibration(str(tmp_path / prefix))
        assert got_t[0] == got_j[0] == (tcam.fx, tcam.fy, tcam.cx, tcam.cy, 64, 48)
        assert abs(got_t[1] - 0.1) < 1e-7 and got_t[1] == got_j[1]
        np.testing.assert_array_equal(got_t[2], got_j[2])
        np.testing.assert_allclose(got_t[2], cf, atol=1e-9, rtol=0)
