"""The port's steady frame (badslam_torch/steady.py) and its chunks on the
CPU, against the JAX package's fused steady frame and scan chunk.

* The masked Gauss-Newton loop (the plain version of the card's WHILE
  nodes) makes no host read: the twin of tests/test_readfree.py:69, with
  every tensor-to-host conversion patched to raise.
* The masked loop gives the host loop's bits, on every steady frame of a
  12-frame sequence: poses, trajectory rows, history and iterations.
* steady_frame against badslam_tpu.frontend._steady_frame_fn on the same
  inputs (carried with badslam_torch.convert), with and without the duel
  of two motion-model estimates. Tolerances: pose, trajectory row and
  history atol 1e-4, the slice's hold (the residual sums are taken in
  another order, which moves each Gauss-Newton minimum by far less); the
  preprocessed depth atol 1e-5 (tests/test_torch_preprocess.py's hold).
* The chunk eligibility gates (tests/test_chunk.py:77's twin), and a
  chunked run against steady_frame_chunking false at tests/test_chunk.py's
  holds: with sequential BA t atol 1e-5 and |q . q'| within 1e-6 of 1, with
  parallel BA (the drain moves from per frame to per chunk) the same
  queued iterations and an ATE within 2x (or 1e-3 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu import frontend as jfront
from badslam_tpu import synthetic as jsyn
from badslam_tpu.ops.pyramid import FramePyramidLevel as JLevel
from badslam_torch import convert
from badslam_torch import synthetic as tsyn
from badslam_torch.config import BadSlamConfig
from badslam_torch.frontend import BadSlam
from badslam_torch.geometry import se3_np as s3
from badslam_torch.io import dataset as tds
from badslam_torch.steady import steady_frame, steady_key

from test_torch_mapping import HostRead, forbid_host_reads

torch.set_num_threads(1)

POSE_ATOL = 1e-4
DEPTH_ATOL = 1e-5
FRAMES = 13


def _config(**kw):
    base = dict(num_scales=4, keyframe_interval=6, max_surfel_count=1 << 14,
                enable_loop_detection=False, fps_restriction=0)
    base.update(kw)
    return BadSlamConfig(**base)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A 160x120 plane sequence (tests/test_chunk.py's scene) and its
    ground truth."""
    path = str(tmp_path_factory.mktemp("steady") / "seq")
    cam = tsyn.default_camera(160, 120)
    scene = tsyn.random_plane_scene(np.random.default_rng(5), 6)
    gt = tsyn.smooth_trajectory(FRAMES, scale=0.003)
    tsyn.write_tum_dataset(path, cam, scene, gt)
    return path, gt


def _slam(path, **kw):
    return BadSlam(_config(**kw), tds.load_tum_dataset(path), "cpu")


def _inputs(slam, i):
    """steady_frame's arguments for frame i on a copy of the front end's
    state (the function writes the trajectory and history in place)."""
    p, b = slam.direct_ba.depth_params, slam.base_kf_global_T_frame
    depth = torch.from_numpy(slam.video.depth_u16(i).astype(np.int32))
    rgb = torch.from_numpy(slam.video.color_u8(i))
    return (slam._steady_key, slam.cam, slam.cams_pyramid, slam.base_kf_pyramid, depth,
            rgb, None, p.a, p.cfactor, b.q, b.t, slam.traj_q.clone(), slam.traj_t.clone(),
            slam._hist_q.clone(), slam._hist_t.clone(), torch.tensor([i]))


def test_forbid_host_reads_fires():
    x = torch.ones(3)
    with pytest.MonkeyPatch.context() as mp:
        forbid_host_reads(mp)
        for read in (lambda: bool(x[0]), lambda: float(x[0]), lambda: int(x[0]),
                     lambda: x[0].item(), lambda: x.tolist(), lambda: x.numpy(),
                     lambda: [1, 2, 3][x[0].to(torch.int64)]):
            with pytest.raises(HostRead):
                read()
    assert bool(x[0]) and x.tolist() == [1.0, 1.0, 1.0]


def test_masked_steady_frame_is_read_free(sequence):
    """The JAX package's read-free steady loop (tests/test_readfree.py:69):
    the port's steady frame with the masked loop and the duel on, the state
    set up with reads allowed; it gives the host loop's result."""
    slam = _slam(sequence[0], max_num_ba_iterations_per_keyframe=0)
    for i in range(4):
        slam.process_frame(i)
    assert slam._hist_n >= 3
    args = _inputs(slam, 4)
    ref = steady_frame(*_inputs(slam, 4), test_two=True, loop="host")
    with pytest.MonkeyPatch.context() as mp:
        forbid_host_reads(mp)
        out = steady_frame(*args, test_two=True, loop="masked")
    for a, b in ((out.q, ref.q), (out.t, ref.t), (out.hist_q, ref.hist_q),
                 (out.traj_t, ref.traj_t)):
        assert torch.equal(a, b)
    assert [int(n) for n in out.iterations] == list(ref.iterations)


def test_masked_loop_equals_host_loop(sequence):
    """On every steady frame of a 12-frame run (a keyframe at 6, so both
    motion-model cases and a new base keyframe), the masked loop gives the
    host loop's bits: pose, trajectory row, history, iterations per scale."""
    slam = _slam(sequence[0], max_num_ba_iterations_per_keyframe=0)
    slam.process_frame(0)
    duels = set()
    for i in range(1, 12):
        args = _inputs(slam, i)
        test_two = slam._hist_n >= 3
        duels.add(test_two)
        host = steady_frame(*args[:11], *(a.clone() for a in args[11:15]), args[15],
                            test_two=test_two, loop="host")
        masked = steady_frame(*args, test_two=test_two, loop="masked")
        for a, b in ((host.q, masked.q), (host.t, masked.t), (host.traj_q, masked.traj_q),
                     (host.traj_t, masked.traj_t), (host.hist_q, masked.hist_q),
                     (host.hist_t, masked.hist_t), (host.frame.depth, masked.frame.depth)):
            assert torch.equal(a, b), i
        assert list(host.iterations) == [int(n) for n in masked.iterations], i
        assert sum(host.iterations) > 0
        slam.process_frame(i)
    assert duels == {False, True}


@pytest.mark.parametrize("test_two", [False, True], ids=["one_estimate", "duel"])
def test_steady_frame_matches_jax(sequence, test_two):
    """steady_frame against the JAX program on the same inputs, made for the
    JAX program and carried into the port with badslam_torch.convert: the
    base keyframe's pyramid from frame 0 (as the port's first frame makes
    it), frame 3's raw images, a history of the ground truth's relative
    poses with a perturbation, a trajectory with one row per frame."""
    path, gt = sequence
    slam = _slam(path, max_num_ba_iterations_per_keyframe=0)
    slam.process_frame(0)
    key, video = slam._steady_key, slam.video
    jcam = jsyn.default_camera(160, 120)
    jcams = tuple(jcam.pyramid_level(s) for s in range(key.num_scales))
    jbase = tuple(JLevel(*(jnp.asarray(plane.numpy()) for plane in level))
                  for level in slam.base_kf_pyramid)
    a, cfactor = jnp.float32(0.0), jnp.zeros((30, 40), jnp.float32)
    # base_T_frame of frames 0, 1, 2 (the ground truth relative to frame 0,
    # frame 2 nudged so the motion model has work to do).
    rel = [s3.mul(s3.inverse(gt[0]), gt[i]) for i in range(3)]
    hist_q = np.stack([r.q for r in rel]).astype(np.float32)
    hist_t = np.stack([r.t for r in rel]).astype(np.float32)
    hist_t[2] += np.float32(0.002)
    traj_q = np.zeros((FRAMES, 4), np.float32)
    traj_q[:, 0] = 1.0
    traj_t = np.zeros((FRAMES, 3), np.float32)
    base = convert.pose_from_numpy(gt[0].q, gt[0].t, "cpu")
    i = 3
    d3, c3 = video.depth_u16(i), video.color_u8(i)

    fn = jfront._steady_frame_fn(tuple(key))
    jframe, _, jtq, jtt, jhq, jht, jq, jt = fn(
        jcam, jcams, jbase, jnp.asarray(d3), jnp.asarray(c3), None, a, cfactor,
        jnp.asarray(base.q.numpy()), jnp.asarray(base.t.numpy()), jnp.asarray(traj_q),
        jnp.asarray(traj_t), jnp.asarray(hist_q), jnp.asarray(hist_t), jnp.int32(i),
        test_two=test_two)

    cam = convert.camera_from_numpy(jcam)
    params = convert.depth_params_from_numpy(a, cfactor, "cpu")
    out = steady_frame(
        key, cam, tuple(convert.camera_from_numpy(c) for c in jcams),
        convert.pyramid_from_numpy(jbase, "cpu"), torch.from_numpy(d3.astype(np.int32)),
        torch.from_numpy(c3), None, params.a, params.cfactor, base.q, base.t,
        torch.from_numpy(traj_q.copy()), torch.from_numpy(traj_t.copy()),
        torch.from_numpy(hist_q.copy()), torch.from_numpy(hist_t.copy()),
        torch.tensor([i]), test_two=test_two)

    np.testing.assert_allclose(out.frame.depth.numpy(), np.asarray(jframe.depth),
                               atol=DEPTH_ATOL, rtol=0)
    for a, b in ((out.q, jq), (out.t, jt), (out.traj_q, jtq), (out.traj_t, jtt),
                 (out.hist_q, jhq), (out.hist_t, jht)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=POSE_ATOL, rtol=0)
    # Only row i of the trajectory was written, and it holds the pose.
    np.testing.assert_array_equal(np.delete(out.traj_q.numpy(), i, 0),
                                  np.delete(traj_q, i, 0))
    np.testing.assert_array_equal(out.traj_q[i].numpy(), out.q.numpy())
    # The pose moved from the base keyframe's: tracking ran.
    assert np.abs(out.t.numpy() - base.t.numpy()).max() > 1e-3


def test_chunk_eligibility_gates(sequence):
    """tests/test_chunk.py:77 on the port, plus the gates the JAX package
    has beyond that test: no estimate_poses, a live viewer, an input
    pyramid level."""
    slam = _slam(sequence[0])
    slam.process_frame(0)  # first keyframe
    assert slam.chunk_eligible(1, FRAMES)
    # pacing disables chunking (per-frame EndFrame semantics)
    slam.config.fps_restriction = 30
    assert not slam.chunk_eligible(1, FRAMES)
    slam.config.fps_restriction = 0
    slam.config.target_frame_rate = 30.0
    assert not slam.chunk_eligible(1, FRAMES)
    slam.config.target_frame_rate = 0.0
    # wrong phase (a keyframe would fall inside the chunk)
    assert not slam.chunk_eligible(2, FRAMES)
    # not enough frames left
    assert not slam.chunk_eligible(1, 3)
    slam.config.estimate_poses = False
    assert not slam.chunk_eligible(1, FRAMES)
    slam.config.estimate_poses = True
    slam.live_viewer = object()
    assert not slam.chunk_eligible(1, FRAMES)
    slam.live_viewer = None
    # flag off
    slam.config.steady_frame_chunking = False
    assert not slam.chunk_eligible(1, FRAMES)
    slam.config.steady_frame_chunking = True
    assert slam.chunk_eligible(1, FRAMES)
    assert not _slam(sequence[0]).chunk_eligible(1, FRAMES)  # no keyframe yet
    level1 = _slam(sequence[0], pyramid_level_for_depth=1, pyramid_level_for_color=1)
    level1.process_frame(0)
    assert not level1.chunk_eligible(1, FRAMES)


def _run(path, chunking, parallel_ba):
    slam = _slam(path, steady_frame_chunking=chunking, parallel_ba=parallel_ba)
    slam.run(0, FRAMES)
    return slam


def _ate(slam, gt):
    q, t = slam.traj_q.numpy(), slam.traj_t.numpy()
    return tsyn.ate_rmse([s3.SE3(q[i].astype(float), t[i].astype(float))
                          for i in range(len(gt))], gt)


def test_chunked_matches_per_frame_sequential_ba(sequence):
    """tests/test_chunk.py:48's twin: with sequential BA the chunk is the
    per-frame path's arithmetic."""
    path, gt = sequence
    ref, chk = _run(path, False, False), _run(path, True, False)
    assert ref.chunks_processed == 0
    assert chk.chunks_processed == 2  # frames 1-5 and 7-11
    assert all(chk.has_pose[:FRAMES])
    assert chk.direct_ba.keyframes.live_count == ref.direct_ba.keyframes.live_count
    np.testing.assert_allclose(chk.traj_t.numpy(), ref.traj_t.numpy(), atol=1e-5)
    dot = np.abs(np.sum(ref.traj_q.numpy() * chk.traj_q.numpy(), axis=-1))
    np.testing.assert_allclose(dot, 1.0, atol=1e-6)
    assert abs(_ate(chk, gt) - _ate(ref, gt)) < 1e-5
    assert [i for i, _ in chk.frame_times_ms] == list(range(FRAMES))


def test_chunked_parallel_ba_ate_matches(sequence):
    """tests/test_chunk.py's parallel-BA twin: the drain moves from per
    frame to once per chunk, so trajectories differ through BA's
    interleaving, but the queue and the accuracy do not."""
    path, gt = sequence
    ref, chk = _run(path, False, True), _run(path, True, True)
    assert chk.chunks_processed == 2
    assert chk.queued_ba_iterations == ref.queued_ba_iterations
    # One drain per chunk, at its last frame, against one per frame.
    assert set(chk.ba_drain_frames) <= {5, 11}
    assert len(ref.ba_drain_frames) > len(chk.ba_drain_frames)
    a_ref, a_chk = _ate(ref, gt), _ate(chk, gt)
    assert a_chk < max(2 * a_ref, 1e-3), (a_chk, a_ref)
