"""badslam_torch's evaluation surface against the JAX package's: the ATE
metric in its three alignments and its device form, the heightmap mesh
scene, and the user tools of badslam_torch.tools (evaluate_ate,
validate_sequence, train_vocabulary, gen_cli_docs) against the JAX
package's tools/ scripts.

Tolerances:
  * ate_rmse (se3, sim3, none) on the same float64 positions: 1e-9 m;
  * ate_rmse_device and the moments' host half, in float64 on the CPU,
    against the host ate_rmse: 1e-6 relative;
  * the heightmap mesh from one seed: exact; its rendering: 1e-5;
  * evaluate_ate on the same files: the same pairs and scale, the
    distances within 1e-12 m;
  * a vocabulary trained on one descriptor array with one seed: equal
    levels in both packages.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from badslam_tpu import synthetic as jsyn
from badslam_tpu.geometry import se3_np as s3
from badslam_tpu.loop.vocabulary import BinaryVocabulary as JVocabulary
from badslam_torch import synthetic as tsyn
from badslam_torch.io.png import read_png, write_png
from badslam_torch.loop.vocabulary import BinaryVocabulary as TVocabulary
from badslam_torch.tools import evaluate_ate, gen_cli_docs, train_vocabulary
from badslam_torch.tools import validate_sequence

torch.set_num_threads(1)

sys.path[:0] = [os.path.join(os.path.dirname(__file__), "..", "tools")]
import evaluate_ate as jax_evaluate_ate  # noqa: E402  (tools/evaluate_ate.py)


def _noisy_trajectory(seed=3, frames=40, sigma=1e-3):
    """Ground truth along smooth_trajectory and an estimate rotated, scaled
    by 1.01, shifted and with noise, as float64 poses."""
    rng = np.random.default_rng(seed)
    gt = [tsyn.SE3(np.asarray(p.q, np.float64), np.asarray(p.t, np.float64))
          for p in tsyn.smooth_trajectory(frames)]
    rot = s3.exp(np.array([0.1, -0.2, 0.05, 0.02, 0.01, -0.03]))
    R = np.asarray(tsyn._quat_to_matrix(rot.q))
    est = [tsyn.SE3(p.q, 1.01 * (R @ p.t) + rot.t + rng.normal(0.0, sigma, 3))
           for p in gt]
    return est, gt


@pytest.mark.parametrize("align", ["se3", "sim3", "none"])
def test_ate_rmse_matches_jax(align):
    est, gt = _noisy_trajectory()
    want = jsyn.ate_rmse(est, gt, align=align)
    assert abs(tsyn.ate_rmse(est, gt, align=align) - want) <= 1e-9
    assert want > 1e-4


def test_ate_rmse_device_matches_host():
    """The device forms on a float32 trajectory tensor (here on the CPU)
    against the host metric of the same float32 values."""
    est, gt = _noisy_trajectory(frames=60, sigma=2e-5)
    traj = torch.tensor(np.stack([p.t for p in est]), dtype=torch.float32)
    gt_t = np.stack([p.t for p in gt])
    host = tsyn.ate_rmse([tsyn.SE3(None, t) for t in traj.numpy()], gt, align="se3")
    dev = tsyn.ate_rmse_device(traj, gt_t)
    assert dev.dtype == torch.float64 and dev.shape == ()
    assert abs(float(dev) - host) <= 1e-6 * host
    C, se, sg = tsyn.ate_moments_device(traj, gt_t)
    assert C.shape == (3, 3)
    assert abs(tsyn.ate_rmse_from_moments(C, se, sg, len(gt)) - host) <= 1e-6 * host
    # The JAX package's float32 device form, for scale.
    jdev = float(jsyn.ate_rmse_device(traj.numpy(), gt_t))
    assert abs(jdev - host) <= 1e-3 * host


def test_heightmap_mesh_matches_jax():
    jmesh = jsyn.heightmap_mesh_scene(np.random.default_rng(0))
    tmesh = tsyn.heightmap_mesh_scene(np.random.default_rng(0))
    for a, b in zip(jmesh, tmesh):
        np.testing.assert_array_equal(b, a)
        assert a.dtype == b.dtype
    cam_j, cam_t = jsyn.default_camera(64, 48), tsyn.default_camera(64, 48)
    rng = np.random.default_rng(1)
    for _ in range(3):
        pose = s3.inverse(s3.exp(0.1 * rng.standard_normal(6)))
        dj, ij = jsyn.render_mesh(cam_j, jmesh, jsyn.HostSE3(pose.q, pose.t))
        dt, it = tsyn.render_mesh(cam_t, tmesh, tsyn.SE3(pose.q, pose.t))
        np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=0)
        np.testing.assert_allclose(it, ij, atol=1e-5, rtol=0)
        assert (dt > 0).mean() > 0.5


def _write_trajectory(path, ts, poses):
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, p in zip(ts, poses):
            q = np.asarray(p.q, np.float64)
            f.write(f"{t:.6f} {p.t[0]} {p.t[1]} {p.t[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n")


@pytest.mark.parametrize("align", ["se3", "sim3", "none"])
def test_evaluate_ate_matches_jax_tool(tmp_path, align):
    """Timestamps off by up to 15 ms and two estimate lines missing, so the
    association does work; both tools on the same two files."""
    est, gt = _noisy_trajectory()
    rng = np.random.default_rng(2)
    ts = np.arange(len(gt)) / 30.0
    keep = [i for i in range(len(est)) if i not in (4, 17)]
    est_path, gt_path = str(tmp_path / "est.txt"), str(tmp_path / "gt.txt")
    _write_trajectory(est_path, ts[keep] + rng.uniform(-0.015, 0.015, len(keep)),
                      [est[i] for i in keep])
    _write_trajectory(gt_path, ts, gt)
    want = jax_evaluate_ate.associate_and_evaluate(est_path, gt_path, align=align)
    got = evaluate_ate.associate_and_evaluate(est_path, gt_path, align=align)
    assert got["pairs"] == want["pairs"] == len(keep)
    assert got["scale"] == pytest.approx(want["scale"], abs=1e-12)
    for key in ("rmse", "mean", "median", "max"):
        assert abs(got[key] - want[key]) <= 1e-12, key
    assert evaluate_ate.main([est_path, gt_path, "--align", align]) == 0


def test_train_vocabulary_writes_what_jax_loads(tmp_path):
    """A TUM dataset directory and a plain PNG directory (gray and RGB
    images) give an .npz that both packages load; JPEG input is refused."""
    data = str(tmp_path / "seq")
    tsyn.write_tum_dataset(data, tsyn.default_camera(160, 120),
                           tsyn.random_plane_scene(np.random.default_rng(4), 4),
                           tsyn.smooth_trajectory(6), albedo=tsyn.textured_intensity_at)
    pngs = tmp_path / "pngs"
    pngs.mkdir()
    rgb = read_png(os.path.join(data, "rgb", "00002.png"))
    write_png(str(pngs / "a.png"), rgb)
    write_png(str(pngs / "b.png"), rgb[..., 0])
    out = str(tmp_path / "vocab.npz")
    assert train_vocabulary.main([out, data, str(pngs), "--k", "4", "--iters", "2",
                                  "--frame_stride", "2", "--quiet"]) == 0
    jv, tv = JVocabulary.load(out), TVocabulary.load(out)
    assert jv.level1.shape == (4, 32) and jv.level2.shape == (4, 4, 32)
    np.testing.assert_array_equal(jv.level2, tv.level2)

    (pngs / "c.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(ValueError, match="only PNG images"):
        train_vocabulary.harvest_descriptors([str(pngs)], frame_stride=1)


def test_vocabulary_training_matches_jax():
    rng = np.random.default_rng(7)
    desc = rng.integers(0, 256, (900, 32), dtype=np.uint8)
    jv = JVocabulary.train(desc, k=6, iters=3, seed=5)
    tv = TVocabulary.train(desc, k=6, iters=3, seed=5)
    np.testing.assert_array_equal(tv.level1, jv.level1)
    np.testing.assert_array_equal(tv.level2, jv.level2)


def test_validate_sequence_prints_one_json_line(capsys):
    assert validate_sequence.main([
        "--device", "cpu", "--frames", "12", "--width", "96", "--height", "72",
        "--keyframe_interval", "6", "--ba_iterations", "2", "--no_loop"]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["ok"] and out["frames"] == 12 and out["backend"] == "cpu"
    assert out["align"] == "se3" and 0 <= out["ate_rmse_m"] < 1e-3
    assert out["fps"] > 0


def test_gen_cli_docs_lists_every_flag(tmp_path, capsys):
    out = tmp_path / "cli.md"
    assert gen_cli_docs.main([str(out)]) == 0
    assert "flags)" in capsys.readouterr().out
    text = out.read_text()
    for flag in ("--device", "--save_timings", "--export_final_timings",
                 "--sync_stage_profiling", "--live"):
        assert f"`{flag}`" in text
    assert gen_cli_docs.main([]) == 0
    assert capsys.readouterr().out == text
