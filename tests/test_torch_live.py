"""badslam_torch live input, the native PNG loader and the convergence tool
against badslam_tpu on the CPU.

Each test is a twin of a JAX-package test, run on both packages with the
same seeded inputs (96x72 frames rendered by badslam_torch.synthetic):
  * DirectoryInput (tests/test_live_inputs.py:38): both follow one
    directory while it is written, a frame's depth PNG first cut short and
    completed later; frames, colors and timestamps exact.
  * TCPInput (:71): the same frames sent to both; exact.
  * the SDK inputs (:136): the same refusal, the same config parameters.
  * run_live (:93): an 8-frame directory stream through both front ends,
    and through the port's CLI with the live viewer; poses atol 1e-4 (the
    slice's hold).
  * the native loader (tests/test_native_loader.py): exact.
  * convergence.analyze (tests/test_loop.py:191): exact (the same numpy).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from badslam_torch import cli, synthetic
from badslam_torch.config import BadSlamConfig
from badslam_torch.frontend import BadSlam
from badslam_torch.geometry.camera import PinholeCamera
from badslam_torch.io import live_inputs, native_loader, png
from badslam_torch.io.dataset import load_tum_trajectory

from badslam_tpu.config import BadSlamConfig as JConfig
from badslam_tpu.frontend import BadSlam as JBadSlam
from badslam_tpu.geometry.camera import PinholeCamera as JCamera
from badslam_tpu.io import live_inputs as jlive
from badslam_tpu.io import native_loader as jnative

torch.set_num_threads(1)

CAM = PinholeCamera(fx=70.0, fy=70.0, cx=48.0, cy=36.0, width=96, height=72)
JCAM = JCamera(fx=70.0, fy=70.0, cx=48.0, cy=36.0, width=96, height=72)
POSE_ATOL = 1e-4
# tests/test_live_inputs.py:123's configuration.
LIVE_CONFIG = dict(num_scales=3, keyframe_interval=4, max_num_ba_iterations_per_keyframe=2,
                   max_surfel_count=1 << 12, tracking_max_iterations=8,
                   enable_loop_detection=False)


def _make_frames(n):
    rng = np.random.default_rng(0)
    scene = synthetic.random_plane_scene(rng, 3)
    gt = synthetic.smooth_trajectory(n, scale=0.003)
    frames = []
    for pose in gt:
        depth, inten = synthetic.render_scene(CAM, scene, pose)
        d16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
        g = np.clip(inten * 255 + 0.5, 0, 255).astype(np.uint8)
        # A color image whose channels differ, so an RGB/BGR swap shows.
        frames.append((d16, np.stack([g, g // 2, 255 - g], -1)))
    return frames, gt


def _stream_dir(path):
    os.makedirs(os.path.join(path, "depth"))
    os.makedirs(os.path.join(path, "rgb"))
    with open(os.path.join(path, "calibration.txt"), "w") as f:
        f.write(f"{CAM.fx} {CAM.fy} {CAM.cx} {CAM.cy}\n")


def _writer(path, frames, gap_s, cut=None):
    """A camera process: writes each frame's PNG pair and, at frame `cut`,
    first a depth PNG cut in half, completed 0.2 s later; then `end`."""
    def write():
        for i, (d16, rgb) in enumerate(frames):
            name = f"{i / 30.0:.6f}.png"
            dpath = os.path.join(path, "depth", name)
            data = png.encode_png(d16)
            if i == cut:
                with open(dpath, "wb") as f:
                    f.write(data[: len(data) // 2])
                png.write_png(os.path.join(path, "rgb", name), rgb)
                time.sleep(0.2)
                with open(dpath, "wb") as f:
                    f.write(data)
            else:
                with open(dpath, "wb") as f:
                    f.write(data)
                png.write_png(os.path.join(path, "rgb", name), rgb)
            time.sleep(gap_s)
        open(os.path.join(path, "end"), "w").close()

    t = threading.Thread(target=write)
    t.start()
    return t


def _png_cuts():
    data = png.encode_png(np.arange(96 * 72, dtype=np.uint16).reshape(72, 96))
    iend = len(data) - 12
    return {"empty": b"", "signature": data[:8], "mid_idat": data[:len(data) // 2],
            "before_iend": data[:iend], "mid_iend": data[:iend + 6],
            "crc": data[:-1] + bytes([data[-1] ^ 1])}


@pytest.mark.parametrize("cut", list(_png_cuts()))
def test_cut_png_is_refused_by_both_decoders(tmp_path, cut):
    """A PNG the producer has not finished writing is never decoded as an
    image: png.py raises ValueError (it used to end its chunk loop quietly
    at a chunk boundary before IEND), the native loader returns None, as
    the JAX package's does."""
    data = _png_cuts()[cut]
    with pytest.raises(ValueError):
        png.decode_png(data)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    if native_loader.available():
        assert native_loader.read_png(path) is None
        assert jnative.read_png(path) is None


def test_directory_input_follows_drops(tmp_path):
    path = str(tmp_path)
    _stream_dir(path)
    frames, _ = _make_frames(5)
    t = _writer(path, frames, 0.03, cut=2)
    port_in = live_inputs.DirectoryInput(path, poll_interval=0.01)
    jax_in = jlive.DirectoryInput(path, poll_interval=0.01)
    try:
        videos = [port_in.start(max_frames=100), jax_in.start(max_frames=100)]
        for video in videos:
            assert (video.camera.width, video.camera.height) == (CAM.width, CAM.height)
            assert video.wait_for_frame(4, timeout=20.0)
            assert not video.wait_for_frame(5, timeout=20.0)
    finally:
        t.join(timeout=30)
        port_in.stop()
        jax_in.stop()
    assert not t.is_alive()
    pv, jv = videos
    for i, (d16, rgb) in enumerate(frames):
        np.testing.assert_array_equal(pv.depth_u16(i), d16)
        np.testing.assert_array_equal(pv.color_u8(i), rgb)
        np.testing.assert_array_equal(jv.depth_u16(i), d16)
        np.testing.assert_array_equal(jv.color_u8(i), rgb)
    assert pv.timestamps == jv.timestamps
    assert abs(pv.timestamps[1] - 1 / 30.0) < 1e-6
    assert pv.undistortion_map is None and len(pv) == 100 and pv.received == 5


def test_directory_frame_that_never_completes_fails_the_stream(tmp_path, monkeypatch):
    """A listed frame that does not decode before the deadline ends the
    stream with an error that the consumer raises, not with a short
    stream."""
    monkeypatch.setattr(live_inputs, "_DEADLINE_S", 0.3)
    path = str(tmp_path)
    _stream_dir(path)
    frames, _ = _make_frames(2)
    for i, (d16, rgb) in enumerate(frames):
        data = png.encode_png(d16)
        with open(os.path.join(path, "depth", f"{i}.png"), "wb") as f:
            f.write(data if i == 0 else data[:-12])  # frame 1 lacks IEND
        png.write_png(os.path.join(path, "rgb", f"{i}.png"), rgb)
    inp = live_inputs.DirectoryInput(path, poll_interval=0.01)
    video = inp.start(max_frames=10)
    try:
        assert video.wait_for_frame(0, timeout=10.0)
        with pytest.raises(RuntimeError, match="did not decode"):
            video.wait_for_frame(1, timeout=10.0)
    finally:
        inp.stop()


def test_tcp_input_stream():
    frames, _ = _make_frames(3)
    videos = []
    for mod, cam in ((live_inputs, CAM), (jlive, JCAM)):
        inp = mod.TCPInput(port=0)

        def client(port=inp.port, mod=mod, cam=cam):
            with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
                for i, (d16, rgb) in enumerate(frames):
                    mod.send_frame(s, i * 0.1, d16, rgb, cam)

        t = threading.Thread(target=client)
        t.start()
        try:
            video = inp.start(max_frames=10)
            assert video.wait_for_frame(2, timeout=10.0)
            assert not video.wait_for_frame(3, timeout=10.0)
        finally:
            t.join(timeout=10)
            inp.stop()
        videos.append(video)
    pv, jv = videos
    assert (pv.camera.fx, pv.camera.cy) == (jv.camera.fx, jv.camera.cy) == (CAM.fx, CAM.cy)
    for i, (d16, rgb) in enumerate(frames):
        np.testing.assert_array_equal(pv.depth_u16(i), d16)
        np.testing.assert_array_equal(pv.color_u8(i), jv.color_u8(i))
    assert pv.timestamps == jv.timestamps


def test_tcp_bad_magic_fails_the_run():
    """A capture thread that fails ends the live run with its error."""
    inp = live_inputs.TCPInput(port=0)
    frames, _ = _make_frames(1)

    def client():
        with socket.create_connection(("127.0.0.1", inp.port), timeout=10) as s:
            live_inputs.send_frame(s, 0.0, *frames[0], CAM)
            s.sendall(b"XXXX" + bytes(live_inputs._TCP_HEADER.size - 4))

    t = threading.Thread(target=client)
    t.start()
    try:
        video = inp.start(max_frames=10)
        slam = BadSlam(BadSlamConfig(**LIVE_CONFIG), video, "cpu")
        with pytest.raises(RuntimeError, match="bad frame magic"):
            slam.run_live()
        assert slam.last_frame_index == 0
    finally:
        t.join(timeout=10)
        inp.stop()


@pytest.mark.parametrize("spec", ["realsense", "k4a", "structure"])
def test_sdk_inputs_refuse_as_jax(spec):
    cfg = dict(k4a_mode="wfov", k4a_fps=15, k4a_exposure=8000, structure_depth_only=True,
               structure_depth_diff_threshold=0.1)
    port_in = live_inputs.open_live_input(spec, BadSlamConfig(**cfg))
    jax_in = jlive.open_live_input(spec, JConfig(**cfg))
    assert type(port_in).__name__ == type(jax_in).__name__
    assert port_in._sdk_options() == jax_in._sdk_options()
    assert set(port_in._sdk_options()) == set(type(port_in).CONFIG_FIELDS)
    with pytest.raises(RuntimeError) as pe:
        port_in.start()
    with pytest.raises(RuntimeError) as je:
        jax_in.start()
    assert str(pe.value) == str(je.value)
    assert "requires its SDK" in str(pe.value)
    # Without a config the port's own defaults apply.
    assert (live_inputs.open_live_input(spec)._sdk_options()
            == jlive.open_live_input(spec)._sdk_options())


def test_unknown_live_input_is_refused():
    with pytest.raises(ValueError, match="unknown live input"):
        live_inputs.open_live_input("webcam")


@pytest.fixture(scope="module")
def live_stream(tmp_path_factory):
    """An 8-frame directory stream (tests/test_live_inputs.py:93): the JAX
    package's run_live follows it while it is written; returns the
    directory, the ground truth and JAX's poses."""
    path = str(tmp_path_factory.mktemp("live"))
    _stream_dir(path)
    frames, gt = _make_frames(8)
    t = _writer(path, frames, 0.02)
    inp = jlive.open_live_input(f"dir:{path}")
    try:
        video = inp.start(max_frames=32)
        slam = JBadSlam(JConfig(**LIVE_CONFIG), video)
        processed = slam.run_live()
    finally:
        t.join(timeout=60)
        inp.stop()
    assert processed == 8
    poses = [slam.frame_pose(i) for i in range(8)]
    q = np.stack([np.asarray(p.q) for p in poses])
    tr = np.stack([np.asarray(p.t) for p in poses])
    return path, gt, q, tr


def test_run_live_matches_jax(live_stream):
    path, gt, jq, jt = live_stream
    inp = live_inputs.open_live_input(f"dir:{path}")
    try:
        video = inp.start(max_frames=32)
        slam = BadSlam(BadSlamConfig(**LIVE_CONFIG), video, "cpu")
        assert slam.traj_q.shape[0] == 32  # sized by the capacity
        processed = slam.run_live()
    finally:
        inp.stop()
    assert processed == 8
    q = slam.traj_q[:8].numpy()
    t = slam.traj_t[:8].numpy()
    np.testing.assert_allclose(q, jq, atol=POSE_ATOL)
    np.testing.assert_allclose(t, jt, atol=POSE_ATOL)
    assert [i for i, _ in slam.live_lag_s] == list(range(8))
    assert all(s > 0 for _, s in slam.live_lag_s)
    assert len(slam.live_backlog) == 8 and slam.live_backlog[-1] == 0
    assert [i for i, _ in slam.frame_times_ms] == list(range(8))
    assert slam.keyframe_frames == [0, 4] and slam.ba_drain_frames == []
    assert synthetic.ate_rmse([slam.frame_pose(i) for i in range(8)], gt) < 0.01


def test_cli_live_with_viewer_matches_jax(live_stream, tmp_path):
    """The port's CLI on the live stream (while a writer fills a second
    directory with the same frames) with the live viewer on a free port and
    the HTML export: the same poses as JAX's run_live, one snapshot per
    keyframe plus the final one."""
    _, _, jq, jt = live_stream
    path = str(tmp_path / "stream")
    _stream_dir(path)
    frames, _ = _make_frames(8)
    t = _writer(path, frames, 0.02)
    view = str(tmp_path / "view")
    html = str(tmp_path / "map.html")
    poses = str(tmp_path / "poses.txt")
    times = str(tmp_path / "times.json")
    flags = [f"--{k}={v}" for k, v in LIVE_CONFIG.items()]
    try:
        slam = cli.run(["--live", f"dir:{path}", "--device", "cpu", *flags,
                        "--live_max_frames", "32", "--live_viewer_dir", view,
                        "--live_viewer_port", "0", "--live_viewer_interval", "1",
                        "--export_viewer", html, "--export_poses", poses,
                        "--export_frame_times", times, "--quiet"])
    finally:
        t.join(timeout=60)
    _, est = load_tum_trajectory(poses)
    assert len(est) == 8
    np.testing.assert_allclose(np.stack([p.q for p in est]), jq, atol=POSE_ATOL)
    np.testing.assert_allclose(np.stack([p.t for p in est]), jt, atol=POSE_ATOL)
    with open(os.path.join(view, "map_data.json")) as f:
        data = json.load(f)
    assert data["generation"] == len(slam.keyframe_frames) + 1 == 3
    assert data["kf_count"] == 2 and len(data["kf_panels"]) == 2
    assert os.path.getsize(html) > 10_000 and '"kf_poses"' in open(html).read()
    with open(times) as f:
        summary = json.load(f)
    assert [i for i, _ in summary["live_lag_ms"]] == list(range(8))
    assert len(summary["live_backlog"]) == 8
    assert slam.live_viewer._server is None  # closed with the run


def test_cli_live_flags_match_jax():
    from badslam_tpu.cli import build_parser as jparser

    names = ("live", "live_max_frames", "export_viewer", "live_viewer_dir",
             "live_viewer_port", "live_viewer_interval")
    pa = cli.build_parser().parse_args([])
    ja = jparser().parse_args([])
    assert {n: getattr(pa, n) for n in names} == {n: getattr(ja, n) for n in names}


def test_cli_live_refuses_load_state(tmp_path):
    """Nothing is opened: the refusal comes before the live source."""
    with pytest.raises(ValueError, match="cannot resume a --live stream"):
        cli.run(["--live", "tcp:0", "--load_state", str(tmp_path / "s.npz"),
                 "--device", "cpu"])


@pytest.mark.skipif(not native_loader.available(),
                    reason="native loader not built (native/build.sh) or libpng missing")
def test_native_png_roundtrip_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    depth = rng.integers(0, 65535, (48, 64), dtype=np.uint16)
    dpath = str(tmp_path / "d.png")
    cv2.imwrite(dpath, depth)
    out = native_loader.read_png(dpath)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, depth)
    np.testing.assert_array_equal(out, jnative.read_png(dpath))
    rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    cpath = str(tmp_path / "c.png")
    cv2.imwrite(cpath, rgb[..., ::-1])  # cv2 writes BGR
    np.testing.assert_array_equal(native_loader.read_png(cpath), rgb)
    assert native_loader.read_png(str(tmp_path / "missing.png")) is None
    assert native_loader.decoder_name().startswith("libpng")


@pytest.mark.skipif(not native_loader.available(),
                    reason="native loader not built (native/build.sh) or libpng missing")
def test_native_prefetch_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    paths, imgs = [], []
    for i in range(6):
        img = rng.integers(0, 65535, (32, 40), dtype=np.uint16)
        p = str(tmp_path / f"{i}.png")
        png.write_png(p, img)
        paths.append(p)
        imgs.append(img)
    loader = native_loader.NativePrefetchLoader(paths, ring=3)
    jloader = jnative.NativePrefetchLoader(paths, ring=3)
    try:
        for i in range(6):
            out = loader.get(i)
            np.testing.assert_array_equal(out, imgs[i])
            np.testing.assert_array_equal(out, jloader.get(i))
        with pytest.raises(IndexError):
            loader.get(6)
    finally:
        loader.close()
        jloader.close()


def test_dataset_reader_decodes_through_either_route(tmp_path, monkeypatch):
    """The dataset's readers give the same arrays through libpng and
    through png.py (the route of a machine without libpng)."""
    from badslam_torch.io import dataset

    rng = np.random.default_rng(2)
    depth = rng.integers(0, 65535, (20, 30), dtype=np.uint16)
    rgb = rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
    png.write_png(str(tmp_path / "d.png"), depth)
    png.write_png(str(tmp_path / "c.png"), rgb)
    routes = []
    for lib_loads in (True, False):
        if not lib_loads:
            monkeypatch.setattr(native_loader, "_lib", None)
            monkeypatch.setattr(native_loader, "_load_error", "no libpng16.so.16")
            assert not native_loader.available()
            assert "io/png.py" in native_loader.decoder_name()
        routes.append((dataset._imread_depth(str(tmp_path / "d.png")),
                       dataset._imread_color(str(tmp_path / "c.png"))))
    for d, c in routes:
        np.testing.assert_array_equal(d, depth)
        np.testing.assert_array_equal(c, rgb)


def test_convergence_analysis_matches_jax():
    from badslam_torch.utils.convergence import ConvergenceRecorder, analyze
    from badslam_tpu.utils.convergence import analyze as janalyze

    rec = ConvergenceRecorder(enabled=True)
    rng = np.random.default_rng(0)
    for _ in range(5):
        mag = 1e-2
        for _ in range(20):
            rec.add_sample(np.concatenate([mag * rng.normal(size=3),
                                           0.1 * mag * rng.normal(size=3)]))
            mag *= 0.4
        rec.end_sequence()
    report = analyze(rec.sequences)
    assert report == janalyze(rec.sequences)
    assert len(report) == 4
    saved = [r["mean_iterations_saved"] for r in report]
    assert saved[0] >= saved[-1] and saved[0] > 3
