"""Self-calibration and the PCG solver end to end: badslam_torch.cli against
badslam_tpu.cli on one 64x48 synthetic sequence of 22 frames with a
keyframe every 2 frames (11 keyframes, so that two BA calls pass the
self-calibration gate of >= 10 keyframes), rendered with the true camera
while calibration.txt holds a perturbed one (fx x 1.005, cx + 1 px,
cy - 1 px).

Paths: (a) the default parallel alternating BA with --optimize_intrinsics;
(b) sequential PCG BA (--use_pcg true --parallel_ba false, 1 outer
iteration per keyframe), without self-calibration over the first 12
frames, and with it over all 22 together with (c) the final BA's PCG pass.

Tolerances:
  * (a) and (b) without self-calibration: trajectories t atol 1e-4 m, q
    atol 1e-4 per frame, the hold of test_torch_slice.py; the exported
    calibration fx..cy 4e-5 relative, a and cfactor atol 1e-5 (values
    ~1e-3). The reduced intrinsics system is ill-conditioned (~1e8,
    test_torch_intrinsics.py) and amplifies the float order of its sums:
    measured 1.1e-5 relative on fx..cy on an 80x60 version of this
    sequence; 4e-5 is test_torch_intrinsics.py's joint-step hold;
  * (b) with self-calibration and (c): t, q atol 1e-3, fx..cy 3e-4
    relative, a and cfactor atol 5e-4. One PCG step agrees with the JAX
    package's to 1e-5 (test_torch_pcg.py), but over the 20 outer
    iterations here the two drift apart: the intrinsics and cfactor
    unknowns are ill-conditioned, the CG's inner products leave them out
    (the JAX package's _dot, kept as it is), and its stopping rule (3
    steps without a new best residual norm) is decided by float rounding
    where that norm is not monotone (one of test_torch_pcg.py's steps
    stops after 15 steps in the port and 20 in the JAX package). Measured
    on this sequence: 4.5e-4 m on one frame, 7.7e-5 relative on fx..cy and
    2.1e-4 on cfactor; without the descriptor residuals 2.1e-4 m and
    1.6e-4 relative, so the drift is not theirs alone.
The port's CG steps per PCG outer iteration are printed (the JAX package
does not report its own; test_torch_pcg.py reads them off its results).
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from badslam_tpu.cli import main as jax_main
from badslam_tpu.io import state as jstate
from badslam_torch import synthetic as tsyn
from badslam_torch.cli import main as torch_main
from badslam_torch.cli import run as torch_run
from badslam_torch.io import dataset as tds
from badslam_torch.io import state as tstate

torch.set_num_threads(1)

FRAMES = 22
WIDTH, HEIGHT = 64, 48
# (pose atol, camera rtol, a / cfactor atol), see the module docstring.
HOLD = {"tight": (1e-4, 4e-5, 1e-5), "pcg-intrinsics": (1e-3, 3e-4, 5e-4)}
FLAGS = ["--num_scales", "3", "--keyframe_interval", "2",
         "--max_num_ba_iterations_per_keyframe", "4",
         "--enable_loop_detection", "false", "--fps_restriction", "0",
         "--max_surfel_count", str(1 << 14), "--quiet"]
PERTURBED = dict(fx=1.005, cx=1.0, cy=-1.0)


def write_miscalibrated_sequence(path, cam, frames=FRAMES, seed=5):
    """The sequence rendered with `cam`; calibration.txt then rewritten with
    the perturbed camera. Returns the ground-truth poses."""
    gt = tsyn.smooth_trajectory(frames)
    tsyn.write_tum_dataset(path, cam, tsyn.random_plane_scene(np.random.default_rng(seed), 6), gt)
    with open(os.path.join(path, "calibration.txt"), "w") as f:
        f.write(f"{cam.fx * PERTURBED['fx']} {cam.fy} {cam.cx + PERTURBED['cx']} "
                f"{cam.cy + PERTURBED['cy']}\n")
    return gt


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("calib") / "seq")
    cam = tsyn.default_camera(WIDTH, HEIGHT)
    return data, cam, write_miscalibrated_sequence(data, cam)


def _trajectory(path):
    _, poses = tds.load_tum_trajectory(path)
    return (np.stack([p.q for p in poses]).astype(np.float64),
            np.stack([p.t for p in poses]).astype(np.float64), poses)


def _camera_error(calib, cam):
    fx, fy, cx, cy = calib[0][:4]
    return max(abs(fx - cam.fx) / cam.fx, abs(fy - cam.fy) / cam.fy,
               abs(cx - cam.cx) / cam.fx, abs(cy - cam.cy) / cam.fx)


PCG = ["--use_pcg", "true", "--parallel_ba", "false",
       "--max_num_ba_iterations_per_keyframe", "1"]


@pytest.mark.parametrize("extra", [
    ["--optimize_intrinsics", "true"],
    PCG + ["--end_frame", "12"],
    PCG + ["--optimize_intrinsics", "true", "--final_ba"],
], ids=["alternating-intrinsics", "pcg", "pcg-intrinsics-final_ba"])
def test_calibration_cli_matches_jax_cli(sequence, tmp_path, extra):
    data, cam, gt = sequence
    frames = 12 if "--end_frame" in extra else FRAMES
    gt = gt[:frames]
    out = {k: (str(tmp_path / f"{k}.txt"), str(tmp_path / k)) for k in ("jax", "torch")}
    times = str(tmp_path / "times.json")
    assert jax_main([data, *FLAGS, *extra, "--export_poses", out["jax"][0],
                     "--export_calibration", out["jax"][1]]) == 0
    assert torch_main([data, "--device", "cpu", *FLAGS, *extra,
                       "--export_poses", out["torch"][0],
                       "--export_calibration", out["torch"][1],
                       "--export_frame_times", times]) == 0
    with open(times) as f:
        summary = json.load(f)
    qj, tj, pj = _trajectory(out["jax"][0])
    qt, tt, pt = _trajectory(out["torch"][0])
    cj = jstate.load_calibration(out["jax"][1])
    ct = tstate.load_calibration(out["torch"][1])
    intrinsics = "--optimize_intrinsics" in extra
    pcg = "--use_pcg" in extra
    print(f"{' '.join(extra)}: BA iterations {summary['ba_iterations']}, "
          f"CG steps (port) {summary['cg_steps']}, intrinsics steps "
          f"{len(summary['intrinsics_step_ms'])}; ATE port "
          f"{tsyn.ate_rmse(pt, gt):.3e} JAX {tsyn.ate_rmse(pj, gt):.3e} m; camera "
          f"error port {_camera_error(ct, cam):.3e} JAX {_camera_error(cj, cam):.3e}")

    print(f"  gaps: t {np.abs(tt - tj).max():.2e} m, q {np.abs(qt - qj).max():.2e}, "
          f"fx..cy {np.max(np.abs(np.subtract(ct[0][:4], cj[0][:4])) / cj[0][:4]):.2e}, "
          f"a {abs(ct[1] - cj[1]):.2e}, cfactor {np.abs(ct[2] - cj[2]).max():.2e}")

    assert len(pt) == len(pj) == frames
    pose_atol, cam_rtol, deform_atol = HOLD["pcg-intrinsics" if pcg and intrinsics
                                            else "tight"]
    np.testing.assert_allclose(tt, tj, atol=pose_atol, rtol=0)
    np.testing.assert_allclose(qt, qj, atol=pose_atol, rtol=0)
    np.testing.assert_allclose(ct[0][:4], cj[0][:4], rtol=cam_rtol, atol=0)
    assert ct[0][4:] == cj[0][4:] == (WIDTH, HEIGHT)
    np.testing.assert_allclose(ct[1], cj[1], atol=deform_atol, rtol=0)
    np.testing.assert_allclose(ct[2], cj[2], atol=deform_atol, rtol=0)
    assert summary["keyframes"] == (frames + 1) // 2
    assert (len(summary["cg_steps"]) > 0) == pcg
    assert all(0 < s <= 30 for s in summary["cg_steps"])
    perturbed = (cam.fx * PERTURBED["fx"], cam.fy, cam.cx + PERTURBED["cx"],
                 cam.cy + PERTURBED["cy"])
    if intrinsics:
        # Two BA calls pass the gate; with parallel BA each runs the
        # intrinsics step after each of its two iterations.
        assert len(summary["intrinsics_step_ms"]) == (0 if pcg else 4)
        assert np.abs(np.subtract(ct[0][:4], perturbed)).max() > 1e-3
        assert np.abs(ct[2]).max() > 0
    else:
        assert ct[0][:4] == perturbed


def test_pcg_with_parallel_ba_warns_and_runs_the_alternating_solver(sequence, tmp_path,
                                                                   caplog):
    """--use_pcg with parallel BA (the default): one warning, then the
    alternating solver, as the JAX package does (the reference refuses PCG
    in parallel mode, bad_slam.cc:1273-1276)."""
    data, _, _ = sequence
    short = FLAGS + ["--end_frame", "7"]
    plain, warned = str(tmp_path / "plain.txt"), str(tmp_path / "pcg.txt")
    with caplog.at_level(logging.WARNING):
        slam = torch_run([data, "--device", "cpu", *short, "--use_pcg", "true",
                          "--export_poses", warned])
    assert sum("use_pcg is not supported with parallel_ba" in r.getMessage()
               for r in caplog.records) == 1
    assert slam.direct_ba.cg_steps == []
    assert torch_main([data, "--device", "cpu", *short, "--export_poses", plain]) == 0
    with open(plain) as a, open(warned) as b:
        assert a.read() == b.read()


def test_self_calibration_gate_counts_ba_runs_before_this_one(tmp_path):
    """The gate of badslam_tpu/frontend.py:708-719 (bad_slam.cc:238-246):
    not before 10 keyframes, at every BA run up to 20, then at every
    intrinsics_optimization_interval-th BA run, counted before this run is.
    25 keyframes at 40x30 with an interval of 3 (the port alone; the
    keyframe frames that self-calibrated are exported)."""
    data = str(tmp_path / "seq")
    cam = tsyn.default_camera(40, 30)
    tsyn.write_tum_dataset(data, cam, tsyn.random_plane_scene(np.random.default_rng(2), 4),
                           tsyn.smooth_trajectory(49))
    times = str(tmp_path / "times.json")
    assert torch_main([data, "--device", "cpu", "--num_scales", "2", "--keyframe_interval", "2",
                       "--max_num_ba_iterations_per_keyframe", "1", "--parallel_ba", "false",
                       "--optimize_intrinsics", "true", "--intrinsics_optimization_interval", "3",
                       "--enable_loop_detection", "false", "--fps_restriction", "0",
                       "--max_surfel_count", str(1 << 12), "--quiet",
                       "--export_frame_times", times]) == 0
    with open(times) as f:
        summary = json.load(f)
    # BA run c (from 0) is the keyframe of frame 2 (c + 1), with c + 2 keyframes.
    want = [2 * (c + 1) for c in range(24)
            if c + 2 >= 10 and (c + 2 <= 20 or c % 3 == 0)]
    # Counting this run before testing would give 42 and 48 for 44.
    assert want == [18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 44]
    assert summary["self_calibration_frames"] == want
    assert len(summary["intrinsics_step_ms"]) == len(want)


def reference_ate_of_chip_smoke_calibration(width=160, height=120,
                                            phases=("calibration", "pcg")):
    """The ATE of the JAX CLI and of the port on the CPU on chip_smoke.py's
    self-calibration input (scene, trajectory, perturbation and flags of its
    calibration and pcg phases) at a reduced size (4 scales instead of 5),
    since its VGA size is not run on the CPU here; prints each phase. The
    JAX package's pcg phase takes over two hours on an 8-core CPU: its PCG
    step compiles anew for each keyframe count and gauge keyframe."""
    import tempfile

    import chip_smoke

    with tempfile.TemporaryDirectory() as work:
        data, gt, cam = chip_smoke.write_miscalibrated_sequence(
            work, "calibration", width, height, chip_smoke.CALIB_FRAMES, 7)
        runs = {"calibration": ("calibration (path a)", chip_smoke.CALIB_FLAGS),
                "pcg": ("pcg (paths b + c)", chip_smoke.PCG_FLAGS)}
        for name, flags in (runs[p] for p in phases):
            flags = [("4" if f == "5" else f) for f in flags]
            ate = {}
            for pkg, run in (("JAX", lambda a: jax_main(a)),
                             ("port", lambda a: torch_main(["--device", "cpu", *a]))):
                out = os.path.join(work, f"{pkg}.txt")
                assert run([data, *flags, "--export_poses", out,
                            "--export_calibration", out + "_calib"]) == 0
                ate[pkg] = (tsyn.ate_rmse(_trajectory(out)[2], gt),
                            _camera_error(tstate.load_calibration(out + "_calib"), cam))
            print(f"{name} at {width}x{height}: ATE / camera error JAX "
                  f"{ate['JAX'][0]:.4e} m / {ate['JAX'][1]:.3e}, port "
                  f"{ate['port'][0]:.4e} m / {ate['port'][1]:.3e}", flush=True)


if __name__ == "__main__":
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    reference_ate_of_chip_smoke_calibration(phases=sys.argv[1:] or ("calibration", "pcg"))
