"""The port's read-free loop-closure attempt (badslam_torch/loop/closure.py,
frontend.BadSlam._attempt_loop_closure) on the CPU, against the JAX
package's read-free closure (badslam_tpu/loop/closure_device.py,
loop/pose_graph.py).

* The device pose graph with a live prefix below its bucket, against
  badslam_tpu.loop.pose_graph.optimize_pose_graph_device on the same padded
  input: atol 1e-5 (float32 dense solves in another order); with loop
  weight 0 a no-op to 1e-6; the padded result against the port's unpadded
  one: 1e-6 on the live rows.
* apply_closure padded as the front end pads it (3 refinement slots with
  one unused, the keypoints to a capacity of 100, the order to a bucket of
  16 with 11 live keyframes in shuffled slots of a 14-slot store), against
  the JAX package's apply_closure on the unpadded inputs (bucket = n_live,
  so no duplicate scatter): poses and trajectory atol 1e-5, the same gate
  outcome, the counter +1; the padded port result equal to the unpadded
  port result to 1e-6. Rejection by each gate leaves the store's poses and
  the trajectory bit-identical (torch.equal) and the counter unchanged.
* The twin of tests/test_readfree.py:137: after a 13-frame run at 96x80
  with 3 scales, a forced attempt of the last keyframe onto the first with
  RANSAC's pose the identity, accepted (drift injected into the last
  keyframe) and rejected (no drift, 40 keypoints: the necessity gate),
  under the masked Gauss-Newton control (the plain version of the card's
  WHILE nodes) with every tensor-to-host conversion patched to raise
  (test_torch_mapping.forbid_host_reads): no host read. The same attempts
  under the host loop: poses and trajectory equal to 1e-6 and the same gate
  outcomes.

One thread; the 13-frame run is made once per module.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from badslam_tpu.geometry.camera import PinholeCamera as JCamera
from badslam_tpu.loop import closure_device as jclosure
from badslam_tpu.loop import pose_graph as jpg
from badslam_torch import synthetic as tsyn
from badslam_torch.config import BadSlamConfig
from badslam_torch.convert import camera_from_numpy
from badslam_torch.frontend import BadSlam
from badslam_torch.geometry import se3 as tse3
from badslam_torch.geometry import se3_np as s3
from badslam_torch.io import dataset as tds
from badslam_torch.loop import closure as tclosure
from badslam_torch.loop import pose_graph as tpg
from badslam_torch.ops.conditional import HOST, MASKED

from test_torch_loop import _brackets
from test_torch_mapping import forbid_host_reads

torch.set_num_threads(1)

N_LIVE, BUCKET, SLOTS, FRAMES = 11, 16, 14, 110
# The drift injected into the last keyframe of the 13-frame run: its
# keypoints then move by about 2 pixels on average, so the necessity gate
# (over 1 pixel) passes with room. Half of it moves them by 0.98 pixels,
# through a detection camera that matches its 640x480 images on both axes.
DRIFT = tsyn.pose(tx=0.08, ty=-0.04, rz=0.02)
JCAM = JCamera(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=128, height=96)


def _keyframes():
    """11 drifted keyframes of a loop (every 10th of 110 frames) and the true
    cur_T_matched of the last against the first."""
    gt = tsyn.loop_trajectory(FRAMES, loop_frames=100, orbit_radius=0.4)
    kfs = [s3.SE3(np.asarray(gt[i].q, float), np.asarray(gt[i].t, float))
           for i in range(0, FRAMES, 10)]
    poses, drift = [], s3.identity()
    for p in kfs:
        poses.append(s3.mul(drift, p))
        drift = s3.mul(s3.exp(np.array([0.001, 0, 0.0005, 0, 0.0017, 0])), drift)
    return gt, poses, s3.mul(s3.inverse(kfs[-1]), kfs[0])


def _stack(poses):
    return (np.stack([p.q for p in poses]).astype(np.float32),
            np.stack([p.t for p in poses]).astype(np.float32))


def test_pose_graph_live_prefix_matches_jax():
    _, poses, cur_T_matched = _keyframes()
    q, t = _stack(poses)
    pad_q = np.concatenate([q, np.repeat(q[:1], BUCKET - N_LIVE, 0)])
    pad_t = np.concatenate([t, np.repeat(t[:1], BUCKET - N_LIVE, 0)])
    z = s3.inverse(cur_T_matched)
    zq, zt = np.asarray(z.q, np.float32), np.asarray(z.t, np.float32)
    for w in (1.0, 0.0):
        jq, jt = jpg.optimize_pose_graph_device(
            jnp.asarray(pad_q), jnp.asarray(pad_t), jnp.int32(N_LIVE), jnp.int32(0),
            jnp.int32(N_LIVE - 1), jnp.asarray(zq), jnp.asarray(zt), jnp.float32(w))
        # n_live, the loop edge and its weight as device scalars, as the
        # closure passes them.
        pq, pt = tpg.optimize_pose_graph_device(
            torch.from_numpy(pad_q), torch.from_numpy(pad_t), torch.tensor(N_LIVE),
            torch.tensor(0), torch.tensor(N_LIVE - 1), torch.from_numpy(zq),
            torch.from_numpy(zt), loop_weight=torch.tensor(w))
        np.testing.assert_allclose(pq.numpy()[:N_LIVE], np.asarray(jq)[:N_LIVE], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(pt.numpy()[:N_LIVE], np.asarray(jt)[:N_LIVE], atol=1e-5,
                                   rtol=0)
        uq, ut = tpg.optimize_pose_graph_device(
            torch.from_numpy(q), torch.from_numpy(t), N_LIVE, 0, N_LIVE - 1,
            torch.from_numpy(zq), torch.from_numpy(zt), loop_weight=w)
        np.testing.assert_allclose(pq.numpy()[:N_LIVE], uq.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(pt.numpy()[:N_LIVE], ut.numpy(), atol=1e-6, rtol=0)
        # The padded vertices stay where they were.
        np.testing.assert_allclose(pt.numpy()[N_LIVE:], pad_t[N_LIVE:], atol=1e-6, rtol=0)
        if w == 0.0:
            np.testing.assert_allclose(pq.numpy(), pad_q, atol=1e-6, rtol=0)
            np.testing.assert_allclose(pt.numpy(), pad_t, atol=1e-6, rtol=0)
        else:
            assert np.abs(pt.numpy()[:N_LIVE] - t).max() > 5e-3


def _closure_case(gate):
    """The store (11 live keyframes in shuffled slots of 14, three free),
    the trajectory, the refinements and the keypoints of a closure of the
    last keyframe onto the first: accepted, or rejected by the consistency
    gate (one refinement 3 cm off) or by the necessity gate (refinements
    that agree with the current poses, so no keypoint moves)."""
    gt, poses, cur_T_matched = _keyframes()
    rng = np.random.default_rng(5)
    slots = rng.permutation(SLOTS)[:N_LIVE]       # keyframe i lives in slots[i]
    kq = np.zeros((SLOTS, 4), np.float32)
    kq[:, 0] = 1.0
    kt = rng.uniform(-1, 1, (SLOTS, 3)).astype(np.float32)
    kq[slots], kt[slots] = _stack(poses)
    drift = tsyn.pose(tx=0.01, rz=0.01)
    traj = [s3.mul(s3.SE3(np.asarray(drift.q, float), np.asarray(drift.t, float)),
                   s3.SE3(np.asarray(p.q, float), np.asarray(p.t, float))) for p in gt]
    for i in range(N_LIVE):
        traj[10 * i] = poses[i]
    tq, tt = _stack(traj)
    if gate == "necessity":
        cur_T_matched = s3.mul(s3.inverse(poses[-1]), poses[0])
    offsets = [[0] * 6, [0.004, 0, 0, 0, 0.002, 0]]
    if gate == "consistency":
        offsets[1] = [0.03, 0, 0, 0, 0, 0]
    rq, rt = _stack([s3.mul(cur_T_matched, s3.exp(np.asarray(o, float))) for o in offsets])
    pts = np.stack([rng.uniform(-1, 1, 60), rng.uniform(-0.7, 0.7, 60),
                    rng.uniform(1.0, 3.0, 60)], -1).astype(np.float32)
    br = _brackets(np.arange(N_LIVE) * 10, slots, FRAMES)
    return dict(kq=kq, kt=kt, tq=tq, tt=tt, order=slots.astype(np.int64), rq=rq, rt=rt,
                pts=pts, br=br)


def _port_closure(case, padded):
    """apply_closure on fresh copies of the case's store and trajectory,
    padded as the front end pads or not; returns (consistent, needed,
    count, kq, kt, tq, tt)."""
    order, rq, rt, pts = case["order"], case["rq"], case["rt"], case["pts"]
    ref_valid = np.ones(2, bool)
    pts_valid = np.ones(len(pts), bool)
    if padded:
        order = np.concatenate([order, np.full(BUCKET - N_LIVE, order[0])])
        rq = np.concatenate([rq, [[1.0, 0, 0, 0]]]).astype(np.float32)
        rt = np.concatenate([rt, np.zeros((1, 3))]).astype(np.float32)
        ref_valid = np.arange(3) < 2
        pts = np.concatenate([pts, np.zeros((40, 3), np.float32)])
        pts_valid = np.arange(100) < 60
    state = [torch.from_numpy(case[k].copy()) for k in ("kq", "kt", "tq", "tt")]
    count = torch.zeros((), dtype=torch.int64)
    res = tclosure.apply_closure(
        state[0], state[1], torch.from_numpy(order), torch.tensor(N_LIVE),
        torch.tensor(N_LIVE - 1), torch.tensor(0), torch.from_numpy(rq), torch.from_numpy(rt),
        torch.from_numpy(ref_valid), torch.from_numpy(pts), torch.from_numpy(pts_valid),
        state[2], state[3], *(torch.from_numpy(a) for a in case["br"]), count,
        camera_from_numpy(JCAM))
    return (bool(res.consistent), bool(res.needed), int(count), *state)


def test_padded_apply_closure_matches_jax():
    case = _closure_case("accept")
    j = jclosure.apply_closure(
        jnp.asarray(case["kq"]), jnp.asarray(case["kt"]),
        jnp.asarray(case["order"].astype(np.int32)), jnp.int32(N_LIVE),
        jnp.int32(N_LIVE - 1), jnp.int32(0), jnp.asarray(case["rq"]), jnp.asarray(case["rt"]),
        jnp.ones(2, bool), jnp.asarray(case["pts"]), jnp.ones(60, bool),
        jnp.asarray(case["tq"]), jnp.asarray(case["tt"]),
        *(jnp.asarray(a) for a in case["br"]), jnp.int32(0), JCAM)
    padded, unpadded = _port_closure(case, True), _port_closure(case, False)
    assert padded[:3] == unpadded[:3] == (True, True, 1)
    assert bool(j[5]) and int(j[4]) == 1
    for got, ref in zip(padded[3:], j[:4]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    for got, ref in zip(padded[3:], unpadded[3:]):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=0)
    # The free slots are untouched, and the closure moved the last keyframe.
    free = np.setdiff1d(np.arange(SLOTS), case["order"])
    assert torch.equal(padded[4][free], torch.from_numpy(case["kt"][free]))
    last = case["order"][-1]
    assert float((padded[4][last] - torch.from_numpy(case["kt"][last])).abs().max()) > 5e-3


@pytest.mark.parametrize("gate", ["consistency", "necessity"])
def test_rejection_leaves_poses_bit_identical(gate):
    case = _closure_case(gate)
    consistent, needed, count, *state = _port_closure(case, True)
    assert (consistent, needed) == ((False, True) if gate == "consistency" else (True, False))
    assert count == 0
    for got, k in zip(state, ("kq", "kt", "tq", "tt")):
        assert torch.equal(got, torch.from_numpy(case[k]))
    j = jclosure._consistency_ok(jnp.asarray(case["rq"]), jnp.asarray(case["rt"]),
                                 jnp.ones(2, bool))
    assert bool(j) == consistent


# ---------------------------------------------------------------------------
# The front end's attempt, read-free
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run13(tmp_path_factory):
    """tests/test_readfree.py:137's run: 13 frames at 96x80, 3 scales, a
    keyframe every 4 frames with 2 BA iterations, loop detection on the
    front end's thread; returns the front end and a copy of the state an
    attempt writes."""
    path = str(tmp_path_factory.mktemp("closure_readfree") / "seq")
    tsyn.write_tum_dataset(path, tsyn.default_camera(96, 80),
                           tsyn.random_plane_scene(np.random.default_rng(4), 3),
                           tsyn.smooth_trajectory(13, scale=0.002))
    config = BadSlamConfig(num_scales=3, keyframe_interval=4,
                           max_num_ba_iterations_per_keyframe=2, max_surfel_count=1 << 13,
                           tracking_max_iterations=8, enable_loop_detection=True,
                           parallel_loop_detection=False)
    slam = BadSlam(config, tds.load_tum_dataset(path), "cpu")
    for i in range(13):
        slam.process_frame(i)
    ks = slam.direct_ba.keyframes
    saved = [x.clone() for x in (ks.q, ks.t, slam.traj_q, slam.traj_t)]
    yield slam, saved
    slam.close()


def _forced_attempt(slam, saved, accept, loop, forbid=False):
    """The state restored, then _attempt_loop_closure(order[-1], order[0],
    identity) under `loop`: with drift injected into the last keyframe
    (accepted), or with 40 keypoints and no drift (rejected by the
    necessity gate). Returns the state after it and the attempt's record."""
    ks = slam.direct_ba.keyframes
    for dst, src in zip((ks.q, ks.t, slam.traj_q, slam.traj_t), saved):
        dst.copy_(src)
    slam.loop_closure_count = 0
    order = ks.live_slots_in_time_order()
    last = order[-1]
    feats = slam.loop_detector.features
    own = feats[last]
    if accept:
        true = s3.SE3(ks.q[last].double().numpy(), ks.t[last].double().numpy())
        moved = s3.mul(s3.SE3(np.asarray(DRIFT.q, float), np.asarray(DRIFT.t, float)), true)
        ks.set_pose(last, tse3.SE3(torch.tensor(moved.q, dtype=torch.float32),
                                   torch.tensor(moved.t, dtype=torch.float32)))
    else:
        rng = np.random.default_rng(0)
        pts = np.stack([rng.uniform(-0.4, 0.4, 40), rng.uniform(-0.3, 0.3, 40),
                        rng.uniform(1.0, 2.0, 40)], -1).astype(np.float32)
        feats[last] = own._replace(points_local=pts)
    before = [x.clone() for x in (ks.q, ks.t, slam.traj_q, slam.traj_t)]
    slam.closure_loop = loop
    try:
        if forbid:
            with pytest.MonkeyPatch.context() as mp:
                forbid_host_reads(mp)
                slam._attempt_loop_closure(last, order[0], s3.identity())
        else:
            slam._attempt_loop_closure(last, order[0], s3.identity())
    finally:
        feats[last] = own
        slam.closure_loop = HOST
    after = [x.clone() for x in (ks.q, ks.t, slam.traj_q, slam.traj_t)]
    return before, after, slam.closure_attempts[-1], slam.loop_closure_count


@pytest.mark.parametrize("accept", [True, False], ids=["accepted", "rejected"])
def test_forced_attempt_is_read_free(run13, accept):
    slam, saved = run13
    before, after, attempt, count = _forced_attempt(slam, saved, accept, MASKED, forbid=True)
    assert attempt["refinements"] == 2
    assert (attempt["consistent"] and attempt["needed"]) == accept
    assert count == int(accept)
    if accept:
        assert float((after[1] - before[1]).abs().max()) > 1e-3
    else:
        assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("accept", [True, False], ids=["accepted", "rejected"])
def test_masked_attempt_equals_host_attempt(run13, accept):
    slam, saved = run13
    _, masked, m_attempt, m_count = _forced_attempt(slam, saved, accept, MASKED)
    _, host, h_attempt, h_count = _forced_attempt(slam, saved, accept, HOST)
    assert m_attempt == h_attempt and m_count == h_count == int(accept)
    for a, b in zip(masked, host):
        assert float((a - b).abs().max()) <= 1e-6
