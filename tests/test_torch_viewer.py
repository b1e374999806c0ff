"""badslam_torch's map viewer and the front end's viewer hooks against
badslam_tpu on the CPU.

One JAX-package run (128x96, 13 frames, a keyframe every 4, 6 BA
iterations per keyframe, no pacing, a live viewer attached) gives the
shared state: its poses, and its `save_state` snapshot, which the port
loads (io/state.py reads JAX snapshots). Tolerances:
  * the run with a viewer: poses atol 1e-4 (the slice's hold), on the
    per-frame drain schedule (a viewer turns off the steady runs, as the
    JAX package's chunk_eligible does);
  * `_snapshot_dict` on the shared state: positions, normals, radii, the
    trajectory, frustum lines, keyframe positions and poses atol 1e-5; the
    keyframe ids, the subsample and the decoded panel pixels exact; the
    refreshed 8-bit colors within 1 level (float sums in another order);
  * the Turbo table and the HTML shell: exact;
  * run controls and the command queue (tests/test_viewer.py:69-138,
    tests/test_color.py:91-195): the same behaviour in both packages;
  * keyframe move and delete on the shared state: poses atol 1e-6, the
    same live keyframes;
  * assign_descriptor_colors (tests/test_color.py:75): atol 1e-4.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
import urllib.request
from urllib.parse import quote

import numpy as np
import pytest
import torch

from badslam_torch import synthetic
from badslam_torch.config import BadSlamConfig
from badslam_torch.frontend import BadSlam
from badslam_torch.io import png
from badslam_torch.io.dataset import load_tum_dataset
from badslam_torch.io.state import load_state
from badslam_torch.mapping import surfels as sf
from badslam_torch.viz import viewer

from badslam_tpu.config import BadSlamConfig as JConfig
from badslam_tpu.frontend import BadSlam as JBadSlam
from badslam_tpu.io.dataset import load_tum_dataset as jload_tum_dataset
from badslam_tpu.io.state import save_state as jsave_state
from badslam_tpu.mapping import surfels as jsf
from badslam_tpu.viz import viewer as jviewer

torch.set_num_threads(1)

FRAMES = 13
VIEW_CONFIG = dict(num_scales=3, keyframe_interval=4, max_surfel_count=1 << 12,
                   max_num_ba_iterations_per_keyframe=6, enable_loop_detection=False,
                   fps_restriction=0)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The JAX package's run with a live viewer attached (no snapshots: the
    interval exceeds the keyframes) and its snapshot."""
    root = tmp_path_factory.mktemp("viewer")
    data = str(root / "ds")
    synthetic.write_tum_dataset(data, synthetic.default_camera(128, 96),
                                synthetic.random_plane_scene(np.random.default_rng(2), 5),
                                synthetic.smooth_trajectory(FRAMES))
    slam = JBadSlam(JConfig(**VIEW_CONFIG), jload_tum_dataset(data))
    slam.live_viewer = jviewer.LiveViewer(str(root / "jview"), port=None, interval=100)
    slam.run()
    slam.live_viewer = None
    q = np.stack([np.asarray(p.q) for p in slam.frame_poses[:FRAMES]])
    t = np.stack([np.asarray(p.t) for p in slam.frame_poses[:FRAMES]])
    state = str(root / "state.npz")
    jsave_state(slam, state)
    return dict(data=data, state=state, q=q, t=t, jslam=slam)


def _port_state(shared):
    return load_state(shared["state"], load_tum_dataset(shared["data"]), "cpu")


@pytest.mark.parametrize("with_viewer", [True, False], ids=["viewer", "no_viewer"])
def test_viewer_run_drain_schedule(shared, tmp_path, with_viewer):
    """With a live viewer each frame drains up to 2 queued BA iterations
    (the JAX package runs no fused steady chunk then) and the poses match
    the JAX package's run with a viewer; without one the steady runs drain
    once at their end."""
    slam = BadSlam(BadSlamConfig(**VIEW_CONFIG), load_tum_dataset(shared["data"]), "cpu")
    if with_viewer:
        slam.live_viewer = viewer.LiveViewer(str(tmp_path / "view"), port=None, interval=100)
    slam.run()
    slam.close()
    if with_viewer:
        assert slam.ba_drain_frames == [5, 6, 9, 10]
        np.testing.assert_allclose(slam.traj_q.numpy(), shared["q"], atol=1e-4)
        np.testing.assert_allclose(slam.traj_t.numpy(), shared["t"], atol=1e-4)
    else:
        assert slam.ba_drain_frames == [7, 11]


def _f32(b64):
    return np.frombuffer(base64.b64decode(b64), np.float32).reshape(-1, 3)


def _pixels(b64):
    return png.decode_png(base64.b64decode(b64))


def test_snapshot_dict_matches_jax(shared):
    slam = _port_state(shared)
    jslam = shared["jslam"]
    n = slam.direct_ba.surfel_count
    assert n > 600
    d = viewer._snapshot_dict(slam, max_points=500, generation=3)
    j = jviewer._snapshot_dict(jslam, max_points=500, generation=3)
    assert d["generation"] == j["generation"] == 3
    assert d["kf_count"] == j["kf_count"] == slam.direct_ba.keyframes.live_count == 4
    for key in ("pos", "nrm", "traj", "kf", "kf_pos"):
        a, b = _f32(d[key]), _f32(j[key])
        assert a.shape == b.shape and len(a) > 0, key
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=key)
    assert len(_f32(d["pos"])) == 500  # the same seeded subsample
    rad = np.frombuffer(base64.b64decode(d["rad"]), np.float32)
    np.testing.assert_allclose(rad, np.frombuffer(base64.b64decode(j["rad"]), np.float32),
                               atol=1e-5)
    col = np.frombuffer(base64.b64decode(d["col"]), np.uint8).astype(int)
    jcol = np.frombuffer(base64.b64decode(j["col"]), np.uint8).astype(int)
    assert np.abs(col - jcol).max() <= 1
    assert json.loads(base64.b64decode(d["kf_ids"])) == json.loads(base64.b64decode(j["kf_ids"]))
    np.testing.assert_allclose(d["kf_poses"], j["kf_poses"], atol=1e-5)
    assert sorted(d["kf_panels"]) == sorted(j["kf_panels"])
    for k, (rgb, depth) in d["kf_panels"].items():
        jrgb, jdepth = j["kf_panels"][k]
        np.testing.assert_array_equal(_pixels(rgb), _pixels(jrgb))
        np.testing.assert_array_equal(_pixels(depth), _pixels(jdepth))
    np.testing.assert_array_equal(_pixels(d["rgb_png"]), _pixels(j["rgb_png"]))
    np.testing.assert_array_equal(_pixels(d["depth_png"]), _pixels(j["depth_png"]))


def test_turbo_table_matches_opencv():
    cv2 = pytest.importorskip("cv2")
    levels = np.arange(256, dtype=np.uint8)[None]
    bgr = cv2.applyColorMap(levels, cv2.COLORMAP_TURBO)[0]
    np.testing.assert_array_equal(viewer._TURBO_RGB, bgr[:, ::-1])


def test_html_shell_equals_jax():
    assert viewer._HTML == jviewer._HTML
    assert "kfNudge" in viewer._HTML and "delete_kf:" in viewer._HTML


def test_export_html_viewer(shared, tmp_path):
    path = str(tmp_path / "map.html")
    viewer.export_html_viewer(_port_state(shared), path)
    html = open(path).read()
    assert '"kf_poses"' in html and '"pos"' in html
    assert "runtime settings" in html and "screenshot" in html and "densify" in html
    assert "__DATA__" not in html and "__CONFIG__" not in html
    assert os.path.getsize(path) > 10_000


@pytest.mark.parametrize("mod", [viewer, jviewer], ids=["torch", "jax"])
def test_live_viewer_pause_step_resume(tmp_path, mod):
    v = mod.LiveViewer(str(tmp_path / "view"), port=None)
    released = []

    def loop():
        for i in range(3):
            v.wait_if_paused()
            released.append(i)

    v.control("pause")
    t = threading.Thread(target=loop, daemon=True)
    t.start()
    time.sleep(0.15)
    assert released == []
    assert v.control("step") == "paused"
    time.sleep(0.15)
    assert released == [0]
    assert v.control("resume") == "running"
    t.join(timeout=2.0)
    assert not t.is_alive() and released == [0, 1, 2]


@pytest.mark.parametrize("mod", [viewer, jviewer], ids=["torch", "jax"])
def test_live_viewer_commands_run_on_wake(tmp_path, mod):
    v = mod.LiveViewer(str(tmp_path / "view"), port=None)
    v.control("pause")
    v.control("ba")
    v.control("set:max_depth=5.0")
    assert v.control("bogus") == "paused"  # not queued
    applied = []

    def loop():
        v.wait_if_paused(on_wake=lambda: applied.extend(v.take_commands()))

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    time.sleep(0.3)
    assert applied == ["ba", "set:max_depth=5.0"]  # while still paused
    v.control("resume")
    t.join(timeout=2.0)
    assert not t.is_alive()


def test_live_viewer_http_and_commands(shared, tmp_path):
    """tests/test_color.py:91's flow on the port: snapshots served over
    HTTP, /control pause and resume, manual densify and BA applied on the
    SLAM thread with a snapshot each, runtime config edits through the
    whitelist."""
    slam = _port_state(shared)
    live = viewer.LiveViewer(str(tmp_path / "view"), port=0, interval=1)
    slam.live_viewer = live
    base = f"http://127.0.0.1:{live.port}"

    def get(path):
        return urllib.request.urlopen(base + path, timeout=10).read()

    try:
        assert b"__DATA__" not in get("/index.html")
        assert get("/control?cmd=pause") == b"paused" and live.paused
        assert get("/control?cmd=resume") == b"running" and not live.paused
        live.on_keyframe(slam)
        data = json.loads(get("/map_data.json"))
        assert data["generation"] == 1 and data["kf_count"] == 4
        assert len(data["kf_panels"]) == 4
        assert json.loads(get("/config.json"))["num_scales"] == 3
        surfels = slam.direct_ba.surfel_count
        iterations = len(slam.direct_ba.iterations_run)
        get("/control?cmd=densify")
        get("/control?cmd=ba")
        live.wait_if_paused(on_wake=slam._apply_viewer_commands)
        assert live.generation == 3
        assert slam.direct_ba.surfel_count > surfels
        assert len(slam.direct_ba.iterations_run) == iterations + 1
        for cmd in ("set:keyframe_interval=7", "set:parallel_ba=false",
                    "set:max_surfel_count=1", "set:keyframe_interval=x",
                    "set:keyframe_interval=0"):
            get("/control?cmd=" + quote(cmd))
        live.wait_if_paused(on_wake=slam._apply_viewer_commands)
        assert slam.config.keyframe_interval == 7
        assert slam.config.parallel_ba is False
        assert slam.config.max_surfel_count == 1 << 12  # not runtime-editable
        assert json.loads(get("/map_data.json"))["generation"] == 3
    finally:
        live.close()


def test_assign_descriptor_colors_matches_jax():
    rng = np.random.default_rng(33)
    desc = rng.normal(0.0, 60.0, (257, 2)).astype(np.float32)
    desc[:3] = [[0.0, -0.0], [180.0, -180.0], [1e4, -1e4]]
    tmap = sf.empty_map(257, "cpu")._replace(desc=torch.from_numpy(desc))
    jmap = jsf.empty_map(257)._replace(desc=desc)
    out = sf.assign_descriptor_colors(tmap).color.numpy()
    ref = np.asarray(jsf.assign_descriptor_colors(jmap).color)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert np.isfinite(out).all() and (out >= 0).all() and (out <= 255.0).all()


class _Commands:
    """A viewer that only hands over commands (tests/test_viewer.py:149)."""

    def __init__(self, cmds):
        self._cmds = list(cmds)

    def take_commands(self):
        cmds, self._cmds = self._cmds, []
        return cmds

    def snapshot(self, slam):
        pass


def test_move_and_delete_keyframe_match_jax(shared):
    """tests/test_viewer.py:140 on the shared state in both packages (this
    test edits the JAX state, so it runs last)."""
    slam, jslam = _port_state(shared), shared["jslam"]
    ks, jks = slam.direct_ba.keyframes, jslam.direct_ba.keyframes
    live_before = ks.live_count
    assert live_before == jks.live_count >= 3
    slot = next(s for s in range(ks.count)
                if s not in ks.free_slot_set and s != slam.base_kf_id)
    t_before = ks.t[slot].clone()

    def apply(cmds):
        for s in (slam, jslam):
            s.live_viewer = _Commands(cmds)
            s._apply_viewer_commands()
            s.live_viewer = None

    apply([f"move_kf:{slot}:0.05,0,0", f"move_kf:{slam.base_kf_id}:0,0.01,0"])
    assert abs(float(ks.t[slot, 0] - t_before[0]) - 0.05) < 1e-6
    np.testing.assert_allclose(ks.t[: ks.count].numpy(), np.asarray(jks.t)[: ks.count], atol=1e-6)
    np.testing.assert_allclose(slam.base_kf_global_T_frame.t.numpy(),
                               np.asarray(jslam.base_kf_global_T_frame.t), atol=1e-6)

    apply([f"delete_kf:{slot}"])
    assert ks.live_count == jks.live_count == live_before - 1
    assert slot in ks.free_slot_set and slot in jks.free_slot_set

    # The base keyframe is not deleted; malformed commands change nothing.
    t_now = ks.t.clone()
    apply([f"delete_kf:{slam.base_kf_id}", "move_kf:banana", "delete_kf:xyz",
           "move_kf:99:1,0,0", f"delete_kf:{slot}"])
    assert ks.live_count == jks.live_count == live_before - 1
    assert ks.free_slot_set == jks.free_slot_set
    assert torch.equal(ks.t, t_now)
