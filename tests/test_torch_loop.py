"""The port's loop-closure modules against the JAX package's, on the same
numpy inputs made from a seed.

Tolerances:
  * host float64 math (se3_np, average_poses, the host trajectory
    deformation): 1e-12; RANSAC's pose 1e-9 with the same inlier mask; the
    host pose graph 1e-9;
  * integer and discrete results exact: Hamming distances, vocabulary
    words (training and quantization), database words, matches, gate
    decisions, detector candidates; L1 and query scores 1e-12;
  * the front end's float32 pose graph 1e-5, and with loop weight 0 a
    no-op to 1e-6; apply_closure: poses and trajectory 1e-5 (the JAX
    package's padded order scatters duplicates of vertex 0; the port drops
    its padded positions), a rejection bit-identical;
  * the port's own extractor is held on outcomes (the JAX package's uses
    OpenCV's ORB): test_loop.py's fixture asserts, and camera points equal
    to the JAX unprojection of its keypoints.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import badslam_tpu.synthetic as jsyn
from badslam_tpu.geometry import se3 as jse3
from badslam_tpu.geometry import se3_np as js3
from badslam_tpu.geometry.camera import PinholeCamera as JCamera
from badslam_tpu.loop import closure_device as jclosure
from badslam_tpu.loop import detector as jdetector
from badslam_tpu.loop import features as jfeatures
from badslam_tpu.loop import pose_graph as jpg
from badslam_tpu.loop import ransac as jransac
from badslam_tpu.loop import trajectory as jtraj
from badslam_tpu.loop import vocabulary as jvocab
from badslam_torch import synthetic as tsyn
from badslam_torch.convert import camera_from_numpy
from badslam_torch.geometry import se3 as tse3
from badslam_torch.geometry import se3_np as ts3
from badslam_torch.io.png import read_png
from badslam_torch.loop import closure as tclosure
from badslam_torch.loop import detector as tdetector
from badslam_torch.loop import features as tfeatures
from badslam_torch.loop import pose_graph as tpg
from badslam_torch.loop import ransac as transac
from badslam_torch.loop import trajectory as ttraj
from badslam_torch.loop import vocabulary as tvocab
from badslam_torch.loop.thread import LoopDetectionThread

torch.set_num_threads(1)


def _rand_pose(rng, t_scale=0.5, r_scale=0.8):
    return js3.exp(np.concatenate([rng.uniform(-t_scale, t_scale, 3),
                                   rng.uniform(-r_scale, r_scale, 3)]))


def _tp(p):  # host SE3 of the JAX package -> the port's
    return ts3.SE3(np.asarray(p.q, float), np.asarray(p.t, float))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a.q), np.asarray(b.q), atol=atol, rtol=0)
    np.testing.assert_allclose(np.asarray(a.t), np.asarray(b.t), atol=atol, rtol=0)


def _textured(rng, h, w):
    """test_loop.py's random 8x8 blocks."""
    img = np.kron(rng.uniform(0.2, 0.8, (h // 8, w // 8)), np.ones((8, 8)))
    return (img * 255).astype(np.uint8)


def _drifted_circle():
    """test_loop.py:63's 10 keyframes on a circle with odometry drift."""
    gt = [js3.identity()]
    for _ in range(1, 10):
        gt.append(js3.mul(gt[-1], js3.exp(np.array([0.2, 0, 0, 0, 0.1, 0]))))
    est = [js3.identity()]
    for i in range(1, 10):
        odo = js3.mul(js3.inverse(gt[i - 1]), gt[i])
        est.append(js3.mul(est[-1], js3.mul(odo, js3.exp(np.array([0.01, 0.004, 0, 0, 0.004, 0])))))
    return gt, est


def _loop_keyframes():
    """test_loop.py:294's 16 drifted keyframes of a loop and the true
    cur_T_matched of keyframe 15 against keyframe 0."""
    gt = jsyn.loop_trajectory(160, loop_frames=150, orbit_radius=0.4)
    kfs = [js3.SE3(np.asarray(gt[i].q, float), np.asarray(gt[i].t, float))
           for i in range(0, 160, 10)]
    poses, drift = [], js3.identity()
    for p in kfs:
        poses.append(js3.mul(drift, p))
        drift = js3.mul(js3.exp(np.array([0.001, 0, 0.0005, 0, 0.0017, 0])), drift)
    return poses, js3.mul(js3.inverse(kfs[15]), kfs[0])


# ----------------------------------------------------------------------------
# Host math
# ----------------------------------------------------------------------------


def test_se3_np_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(20, 3))
    for _ in range(10):
        a, b = _rand_pose(rng), _rand_pose(rng)
        ta, tb = _tp(a), _tp(b)
        _close(ts3.mul(ta, tb), js3.mul(a, b), 1e-12)
        _close(ts3.inverse(ta), js3.inverse(a), 1e-12)
        np.testing.assert_allclose(ts3.log(ta), js3.log(a), atol=1e-12, rtol=0)
        xi = rng.normal(size=6)
        _close(ts3.exp(xi), js3.exp(xi), 1e-12)
        R = js3.quat_to_matrix(a.q)
        np.testing.assert_allclose(ts3.quat_to_matrix(ta.q), R, atol=1e-12, rtol=0)
        np.testing.assert_allclose(ts3.matrix_to_quat(R), js3.matrix_to_quat(R), atol=1e-12, rtol=0)
        np.testing.assert_allclose(ts3.slerp(ta.q, tb.q, 0.3), js3.slerp(a.q, b.q, 0.3),
                                   atol=1e-12, rtol=0)
        np.testing.assert_allclose(ts3.transform_points(ta, pts), js3.transform_points(a, pts),
                                   atol=1e-12, rtol=0)
    dev = tse3.SE3(torch.tensor([0.6, 0.0, 0.8, 0.0]), torch.tensor([1.0, 2.0, 3.0]))
    _close(ts3.from_device(dev), js3.SE3(np.array([0.6, 0.0, 0.8, 0.0]), np.array([1.0, 2.0, 3.0])),
           1e-7)


def test_average_poses_and_host_deformation_match_jax():
    rng = np.random.default_rng(6)
    base = _rand_pose(rng)
    poses = [js3.mul(base, js3.exp(np.array([d, -d, 0, 0, 0, d]))) for d in (-0.01, 0.0, 0.01)]
    poses[1] = js3.SE3(-poses[1].q, poses[1].t)  # the other hemisphere
    _close(tdetector.average_poses([_tp(p) for p in poses]), jdetector.average_poses(poses), 1e-12)

    # test_loop.py's deformation fixture, with rotations and an unposed frame.
    frames = [js3.mul(js3.exp(np.array([i * 0.1, 0, 0, 0, 0.02 * i, 0])), js3.identity())
              for i in range(12)]
    frames[3] = None
    kf_idx = [1, 5, 10]
    old = [js3.inverse(frames[i]) for i in kf_idx]
    shift = js3.exp(np.array([0.0, 0.5, 0.1, 0.05, 0, 0.02]))
    new = [frames[1], js3.mul(shift, frames[5]), js3.mul(shift, frames[10])]
    out_j = jtraj.extrapolate_and_interpolate_keyframe_pose_changes(frames, kf_idx, old, new)
    out_t = ttraj.extrapolate_and_interpolate_keyframe_pose_changes(
        [None if f is None else _tp(f) for f in frames], kf_idx,
        [_tp(p) for p in old], [_tp(p) for p in new])
    assert out_t[3] is None and out_j[3] is None
    for a, b in zip(out_t, out_j):
        if a is not None:
            _close(a, b, 1e-12)


def test_rigid_align_and_ransac_match_jax():
    rng = np.random.default_rng(2)
    gt = _rand_pose(rng, 0.5, 0.5)
    a = rng.normal(size=(120, 3)) * 2.0
    b = js3.transform_points(gt, a)
    b[:48] += rng.normal(size=(48, 3))
    _close(transac.rigid_align(a[48:], b[48:]), jransac.rigid_align(a[48:], b[48:]), 1e-12)
    for seed in (None, 7):
        def gen():
            return None if seed is None else np.random.default_rng(seed)
        pose_j, inl_j = jransac.ransac_point_cloud_alignment(a, b, threshold=0.03, rng=gen())
        pose_t, inl_t = transac.ransac_point_cloud_alignment(a, b, threshold=0.03, rng=gen())
        np.testing.assert_array_equal(inl_t, inl_j)
        assert inl_t[48:].mean() > 0.95
        _close(pose_t, pose_j, 1e-9)
    # Too few inliers: no pose in either.
    assert transac.ransac_point_cloud_alignment(a[:5], b[:5], min_inliers=10)[0] is None
    assert jransac.ransac_point_cloud_alignment(a[:5], b[:5], min_inliers=10)[0] is None


def test_host_pose_graph_matches_jax():
    gt, est = _drifted_circle()
    edges_j = jpg.odometry_chain_edges(est)
    edges_j.append(jpg.PoseGraphEdge(0, 9, js3.mul(js3.inverse(gt[0]), gt[-1])))
    edges_t = tpg.odometry_chain_edges([_tp(p) for p in est])
    edges_t.append(tpg.PoseGraphEdge(0, 9, _tp(js3.mul(js3.inverse(gt[0]), gt[-1]))))
    for e_t, e_j in zip(edges_t, edges_j):
        _close(e_t.measurement, e_j.measurement, 1e-12)
        np.testing.assert_allclose(tpg._adjoint(e_t.measurement), jpg._adjoint(e_j.measurement),
                                   atol=1e-12, rtol=0)
    opt_j = jpg.optimize_pose_graph(est, edges_j, fixed=0, iterations=30)
    opt_t = tpg.optimize_pose_graph([_tp(p) for p in est], edges_t, fixed=0, iterations=30)
    for a, b in zip(opt_t, opt_j):
        _close(a, b, 1e-9)
    drift = [np.linalg.norm(js3.log(js3.mul(js3.inverse(p[-1]), gt[-1]))) for p in (est, opt_t)]
    assert drift[1] < 0.3 * drift[0]


def test_device_pose_graph_matches_jax():
    poses, cur_T_matched = _loop_keyframes()
    z = js3.inverse(cur_T_matched)
    q = np.stack([p.q for p in poses]).astype(np.float32)
    t = np.stack([p.t for p in poses]).astype(np.float32)
    zq, zt = np.asarray(z.q, np.float32), np.asarray(z.t, np.float32)
    for w in (1.0, 0.0):
        jq, jt = jpg.optimize_pose_graph_device(
            jnp.asarray(q), jnp.asarray(t), jnp.int32(16), jnp.int32(0), jnp.int32(15),
            jnp.asarray(zq), jnp.asarray(zt), jnp.float32(w))
        pq, pt = tpg.optimize_pose_graph_device(
            torch.from_numpy(q), torch.from_numpy(t), 16, 0, 15,
            torch.from_numpy(zq), torch.from_numpy(zt), loop_weight=w)
        np.testing.assert_allclose(pq.numpy(), np.asarray(jq), atol=1e-5, rtol=0)
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-5, rtol=0)
        if w == 0.0:  # the zero-weight graph is a no-op up to rounding
            np.testing.assert_allclose(pq.numpy(), q, atol=1e-6, rtol=0)
            np.testing.assert_allclose(pt.numpy(), t, atol=1e-6, rtol=0)
        else:
            assert np.abs(pt.numpy() - t).max() > 1e-2


# ----------------------------------------------------------------------------
# Vocabulary, database and matching
# ----------------------------------------------------------------------------


def _descriptor_clusters(seed, n=600):
    """Descriptors around 12 centers with sparse bit noise."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 256, (12, 32), dtype=np.uint8)
    noise = (rng.integers(0, 256, (n, 32), dtype=np.uint8)
             & rng.integers(0, 256, (n, 32), dtype=np.uint8)
             & rng.integers(0, 256, (n, 32), dtype=np.uint8))
    return centers[rng.integers(0, 12, n)] ^ noise


def test_vocabulary_and_database_match_jax(tmp_path):
    desc = _descriptor_clusters(0)
    np.testing.assert_array_equal(tvocab.hamming_matrix(desc[:50], desc[50:90]),
                                  jvocab.hamming_matrix(desc[:50], desc[50:90]))
    np.testing.assert_array_equal(tvocab._bit_majority(desc), jvocab._bit_majority(desc))
    for k, iters, sub in ((32, 4, desc), (16, 3, desc[:200]), (8, 2, desc[:5])):
        vj = jvocab.BinaryVocabulary.train(sub, k=k, iters=iters)
        vt = tvocab.BinaryVocabulary.train(sub, k=k, iters=iters)
        np.testing.assert_array_equal(vt.level1, vj.level1)
        np.testing.assert_array_equal(vt.level2, vj.level2)
        np.testing.assert_array_equal(vt.quantize(desc), vj.quantize(desc))

    # A vocabulary saved by the JAX package loads into the port.
    path = str(tmp_path / "vocab.npz")
    vj = jvocab.BinaryVocabulary.train(desc, k=16, iters=3, seed=5)
    vj.save(path)
    vt = tvocab.BinaryVocabulary.load(path)
    other = _descriptor_clusters(1)
    np.testing.assert_array_equal(vt.quantize(other), vj.quantize(other))

    dbj, dbt = jvocab.BowDatabase(vj), tvocab.BowDatabase(vt)
    for kf in range(6):
        d = _descriptor_clusters(10 + kf % 3, 150)
        va, vb = dbj.add(kf, d), dbt.add(kf, d)
        assert va.keys() == vb.keys()
        np.testing.assert_array_equal(dbt.words[kf], dbj.words[kf])
    dbj.remove(2)
    dbt.remove(2)
    assert dbt.inverted.keys() == dbj.inverted.keys()
    q = tvocab.bow_vector(vt.quantize(_descriptor_clusters(11, 150)))
    assert q == jvocab.bow_vector(vj.quantize(_descriptor_clusters(11, 150)))
    rj, rt = dbj.query(q, exclude=(0,)), dbt.query(q, exclude=(0,))
    assert [kf for kf, _ in rt] == [kf for kf, _ in rj] and len(rt) == 4
    np.testing.assert_allclose([s for _, s in rt], [s for _, s in rj], atol=1e-12, rtol=0)
    for a in range(6):
        if a != 2:
            assert abs(tvocab.l1_score(q, dbt.vectors[a]) - jvocab.l1_score(q, dbj.vectors[a])) <= 1e-12


def test_matching_matches_jax():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (400, 32), dtype=np.uint8)
    flips = (rng.integers(0, 256, (400, 32), dtype=np.uint8)
             & rng.integers(0, 256, (400, 32), dtype=np.uint8)
             & rng.integers(0, 256, (400, 32), dtype=np.uint8))
    noisy = (base ^ flips)[rng.permutation(400)]
    vocab = jvocab.BinaryVocabulary.train(base, k=16, iters=3)
    wa, wb = vocab.quantize(base), vocab.quantize(noisy)
    for da, db_ in ((base, noisy), (base[:1], noisy), (base, noisy[:1]), (base[:0], noisy)):
        np.testing.assert_array_equal(tfeatures.match_descriptors(da, db_),
                                      jfeatures.match_descriptors(da, db_))
    pt = tfeatures.match_descriptors_by_word(base, wa, noisy, wb, k=vocab.k)
    np.testing.assert_array_equal(pt, jfeatures.match_descriptors_by_word(base, wa, noisy, wb,
                                                                          k=vocab.k))
    assert len(pt) > 200
    assert tfeatures.bow_score(base, noisy) == jfeatures.bow_score(base, noisy)


# ----------------------------------------------------------------------------
# The extractor
# ----------------------------------------------------------------------------


def test_extractor_passes_the_feature_matching_fixture():
    """test_loop.py:151 with the port's own extractor."""
    rng = np.random.default_rng(5)
    cam = tsyn.default_camera(320, 240)
    gray = _textured(rng, 240, 320)
    depth = np.full((240, 320), 2.0, np.float32)
    depth[:40] = 0.0  # keypoints without depth are dropped

    f = tfeatures.extract_features(gray, depth, cam)
    assert len(f.descriptors) > 50
    assert f.keypoints.dtype == np.float32 and f.points_local.dtype == np.float32
    assert f.descriptors.dtype == np.uint8 and f.descriptors.shape[1] == 32
    # Camera points: the JAX package's unprojection of the keypoints.
    px, py = f.keypoints[:, 0].astype(np.int32), f.keypoints[:, 1].astype(np.int32)
    assert (py >= 40).all()
    expect = np.stack([2.0 * (px + 0.5 - cam.cx) / cam.fx, 2.0 * (py + 0.5 - cam.cy) / cam.fy,
                       np.full(len(px), 2.0)], -1).astype(np.float32)
    np.testing.assert_array_equal(f.points_local, expect)

    pairs = tfeatures.match_descriptors(f.descriptors, f.descriptors)
    assert len(pairs) == len(f.descriptors)
    assert tfeatures.bow_score(f.descriptors, f.descriptors) > 0.99

    depth = np.full((240, 320), 2.0, np.float32)
    det = tdetector.LoopDetector(cam=cam, recent_window=3, temporal_consistency=1)
    det.add_keyframe(gray, depth)
    other = _textured(np.random.default_rng(99), 240, 320)
    for _ in range(4):
        det.add_keyframe(other, depth)
    kf = det.add_keyframe(gray, depth)
    cand = det.detect_candidate(kf)
    assert cand == 0
    pose, inliers = det.initial_alignment(kf, cand)
    assert np.linalg.norm(pose.t) < 0.05
    assert inliers > 50
    # A rotated view still matches: the descriptor is steered.
    rot = np.ascontiguousarray(np.rot90(gray[:, 40:280]))
    fr = tfeatures.extract_features(rot, np.full(rot.shape, 2.0, np.float32),
                                    tsyn.default_camera(240, 240))
    assert len(tfeatures.match_descriptors(fr.descriptors, f.descriptors)) > 0.3 * len(fr.descriptors)


def test_fast_corners_of_a_square():
    """A bright square on a dark background: FAST-9 fires at its 4 corners
    (after non-maximum suppression, one pixel each) and nowhere else."""
    img = np.full((80, 80), 40, np.uint8)
    img[30:50, 30:50] = 200
    x, y, score = tfeatures.fast_corners(img)
    assert sorted(zip(x.tolist(), y.tolist())) == [(30, 30), (30, 49), (49, 30), (49, 49)]
    assert (score > 0).all()
    assert len(tfeatures.fast_corners(np.full((80, 80), 40, np.uint8))[0]) == 0


def test_detection_resize_matches_opencv():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    gray = rng.integers(0, 256, (96, 128), dtype=np.uint8)
    depth = rng.uniform(0.5, 3.0, (96, 128)).astype(np.float32)
    for w, h in ((64, 48), (128, 96)):  # OpenCV's own rounding differs at other factors
        np.testing.assert_array_equal(tfeatures.resize_area_u8(gray, w, h),
                                      cv2.resize(gray, (w, h), interpolation=cv2.INTER_AREA))
    for w, h in ((64, 48), (100, 70), (256, 192)):
        np.testing.assert_array_equal(tfeatures.resize_nearest(depth, w, h),
                                      cv2.resize(depth, (w, h), interpolation=cv2.INTER_NEAREST))


# ----------------------------------------------------------------------------
# The detector and its thread
# ----------------------------------------------------------------------------


def _revisit_sequence():
    """12 keyframes at 160x120: 4 textures, 4 others, then the first 4
    again shifted by a pixel (a revisit)."""
    rng = np.random.default_rng(21)
    first = [_textured(rng, 120, 160) for _ in range(4)]
    others = [_textured(rng, 120, 160) for _ in range(4)]
    again = [np.roll(g, (1, 1), axis=(0, 1)) for g in first]
    depth = np.fromfunction(lambda y, x: 1.5 + 0.004 * x + 0.002 * y, (120, 160)).astype(np.float32)
    return first + others + again, depth


def _jax_features_for_the_port(monkeypatch):
    """The port's detector extracts with the JAX package's OpenCV ORB."""
    pytest.importorskip("cv2")

    def extract(gray, depth, cam, max_features=500):
        f = jfeatures.extract_features(gray, depth, cam, max_features)
        return tfeatures.KeyframeFeatures(*f)

    monkeypatch.setattr(tdetector, "extract_features", extract)


def test_detector_with_jax_features_matches_jax(monkeypatch):
    _jax_features_for_the_port(monkeypatch)
    grays, depth = _revisit_sequence()
    jcam = JCamera(fx=140.0, fy=140.0, cx=80.0, cy=60.0, width=160, height=120)
    kw = dict(recent_window=3, images_size=(160, 120))
    dj = jdetector.LoopDetector(cam=jcam, **kw)
    dt = tdetector.LoopDetector(cam=camera_from_numpy(jcam), **kw)
    cands, aligned = [], 0
    for i, g in enumerate(grays):
        assert dt.add_keyframe(g, depth) == dj.add_keyframe(g, depth) == i
        cj, ct = dj.detect_candidate(i), dt.detect_candidate(i)
        assert ct == cj
        cands.append(ct)
        if ct is not None:
            init_j, init_t = dj.initial_alignment(i, cj), dt.initial_alignment(i, ct)
            assert (init_t is None) == (init_j is None)
            if init_t is not None:
                assert init_t[1] == init_j[1] > 25
                _close(init_t[0], init_j[0], 1e-9)
                aligned += 1
    # ORB on these blocks also aliases keyframes 6 and 7 with 0 and 1;
    # geometric verification rejects those.
    assert cands == [None] * 6 + [0, 1, 0, 1, 2, 3] and aligned == 3
    # Removing a keyframe forgets it in both.
    dj.remove_keyframe(3)
    dt.remove_keyframe(3)
    assert dt._order == dj._order and dt._db.vectors.keys() == dj._db.vectors.keys()
    assert len(dt.timings_ms["extract"]) == len(dt.feature_counts) == 12


def test_thread_matches_synchronous_detector():
    grays, depth = _revisit_sequence()
    cam = tsyn.default_camera(160, 120)
    sync = tdetector.LoopDetector(cam=cam, recent_window=3, images_size=(160, 120))
    expect = []
    for i, g in enumerate(grays):
        sync.add_keyframe(g, depth, kf_id=i)
        c = sync.detect_candidate(i)
        expect.append((i, c, None if c is None else sync.initial_alignment(i, c)))
    assert [c for _, c, _ in expect][-2:] == [2, 3]

    thread = LoopDetectionThread(tdetector.LoopDetector(cam=cam, recent_window=3,
                                                        images_size=(160, 120)))
    try:
        seq = [thread.enqueue(i, g, depth) for i, g in enumerate(grays)]
        thread.wait_through(seq[-1])
        got = thread.drain_results()
    finally:
        thread.stop()
    assert [(r.kf_id, r.candidate) for r in got] == [(i, c) for i, c, _ in expect]
    for r, (_, _, init) in zip(got, expect):
        if init is None:
            assert r.cur_T_matched is None
        else:
            _close(r.cur_T_matched, init[0], 0.0)
            assert r.inliers == init[1]
    assert len(thread.worker_ms) == 12


def test_thread_ownership_and_worker_failure():
    """Once the thread owns the detector, main-thread access asserts (as
    test_loop.py:265); a worker's exception is raised on the caller's thread
    at the next wait, and the worker goes on."""
    cam = tsyn.default_camera(80, 60)
    det = tdetector.LoopDetector(cam=cam)
    thread = LoopDetectionThread(det)
    gray = np.zeros((60, 80), np.uint8)
    depth = np.ones((60, 80), np.float32)
    try:
        thread.wait_through(thread.enqueue(0, gray, depth))
        with pytest.raises(AssertionError):
            det.add_keyframe(gray, depth, kf_id=1)
        with pytest.raises(AssertionError):
            det.remove_keyframe(0)
        assert det._owner_thread == thread._thread.ident != threading.get_ident()
        bad = thread.enqueue(1, None, depth)  # no image
        with pytest.raises(RuntimeError, match="worker thread"):
            thread.wait_through(bad)
        thread.wait_through(thread.register(2, gray, depth))
        assert det._order == [0, 2]
    finally:
        thread.stop()


# ----------------------------------------------------------------------------
# Gates and apply_closure
# ----------------------------------------------------------------------------


def _refinements(offsets):
    """cur_T_matched candidates around a base pose; each offset is a twist."""
    base = js3.exp(np.array([0.3, -0.1, 0.2, 0.1, 0.4, -0.2]))
    ps = [js3.mul(base, js3.exp(np.asarray(o, float))) for o in offsets]
    return (np.stack([p.q for p in ps]).astype(np.float32),
            np.stack([p.t for p in ps]).astype(np.float32))


@pytest.mark.parametrize("offsets, valid, expect", [
    ([[0] * 6, [0.019, 0, 0, 0, 0, 0], [0, 0.005, 0, 0, 0, 0]], [1, 1, 1], True),
    ([[0] * 6, [0.021, 0, 0, 0, 0, 0], [0, 0.005, 0, 0, 0, 0]], [1, 1, 1], False),
    ([[0] * 6, [0, 0, 0, 0.172, 0, 0], [0] * 6], [1, 1, 1], True),     # 9.85 deg
    ([[0] * 6, [0, 0, 0, 0.177, 0, 0], [0] * 6], [1, 1, 1], False),    # 10.1 deg
    ([[0] * 6, [0.5, 0, 0, 0, 0, 0], [0] * 6], [1, 0, 1], True),       # the far one invalid
    ([[0] * 6, [0] * 6, [0] * 6], [1, 0, 0], False),                   # one valid
], ids=["1.9cm", "2.1cm", "9.85deg", "10.1deg", "masked", "one_valid"])
def test_consistency_gate_matches_jax(offsets, valid, expect):
    q, t = _refinements(offsets)
    v = np.asarray(valid, bool)
    got = bool(tclosure._consistency_ok(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(v)))
    assert got == bool(jclosure._consistency_ok(jnp.asarray(q), jnp.asarray(t), jnp.asarray(v))) == expect
    avg_t = tclosure._average_pose(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(v))
    avg_j = jclosure._average_pose(jnp.asarray(q), jnp.asarray(t), jnp.asarray(v))
    _close(avg_t, avg_j, 1e-7)


@pytest.mark.parametrize("shift, n_pts, expect", [
    (0.9, 40, False), (1.1, 40, True), (0.0, 4, True), (0.0, 5, False),
], ids=["0.9px", "1.1px", "4_points", "5_points"])
def test_necessity_gate_matches_jax(shift, n_pts, expect):
    """Mean keypoint motion above 1 px, or fewer than 5 projectable points."""
    jcam = JCamera(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=128, height=96)
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-0.5, 0.5, 40), rng.uniform(-0.4, 0.4, 40),
                    rng.uniform(1.5, 2.5, 40)], -1).astype(np.float32)
    valid = np.arange(40) < n_pts
    pts[~valid, 2] = -1.0  # invalid ones also fail to project
    # A sideways shift of `shift` pixels at depth 2 m for every point
    # (x moves by fx * dx / z).
    est = js3.SE3(np.array([1.0, 0, 0, 0]), np.zeros(3))
    actual = js3.SE3(np.array([1.0, 0, 0, 0]), np.array([0.0, 0, 0]))
    pts[:, 2] = np.where(valid, 2.0, pts[:, 2])
    actual = js3.SE3(actual.q, np.array([shift * 2.0 / 100.0, 0, 0]))
    jgot = bool(jclosure._closure_needed(
        jcam, jnp.asarray(pts), jnp.asarray(valid),
        jse3.SE3(jnp.asarray(est.q, jnp.float32), jnp.asarray(est.t, jnp.float32)),
        jse3.SE3(jnp.asarray(actual.q, jnp.float32), jnp.asarray(actual.t, jnp.float32))))
    tgot = bool(tclosure._closure_needed(
        camera_from_numpy(jcam), torch.from_numpy(pts), torch.from_numpy(valid),
        tse3.SE3(torch.tensor(est.q, dtype=torch.float32), torch.tensor(est.t, dtype=torch.float32)),
        tse3.SE3(torch.tensor(actual.q, dtype=torch.float32),
                 torch.tensor(actual.t, dtype=torch.float32))))
    assert tgot == jgot == expect


def _brackets(kf_frames, kf_slots, n_frames):
    """The front end's deformation brackets (frontend._bracket_arrays)."""
    o = np.argsort(kf_frames)
    kf_frames, kf_slots = np.asarray(kf_frames)[o], np.asarray(kf_slots)[o]
    nk = len(kf_frames)
    fi = np.arange(n_frames)
    j = np.searchsorted(kf_frames, fi, side="right")
    prev_i, next_i = np.clip(j - 1, 0, nk - 1), np.clip(j, 0, nk - 1)
    interior = (j > 0) & (j < nk)
    alpha = np.where(interior, (fi - kf_frames[prev_i]) / np.maximum(
        kf_frames[next_i] - kf_frames[prev_i], 1), 0.0)
    end = np.where(j == 0, 0, nk - 1)
    kf_slot = np.full(n_frames, -1)
    kf_slot[kf_frames] = kf_slots
    return (kf_slots[np.where(interior, prev_i, end)], kf_slots[np.where(interior, next_i, end)],
            alpha.astype(np.float32), kf_slot)


@pytest.mark.parametrize("accept", [True, False], ids=["accepted", "rejected"])
def test_apply_closure_matches_jax(accept):
    """16 drifted keyframes of a loop in shuffled slots, closing keyframe 15
    onto keyframe 0; rejected when one refinement is 3 cm off."""
    poses, cur_T_matched = _loop_keyframes()
    n = len(poses)
    slots = np.random.default_rng(0).permutation(n)       # keyframe i lives in slots[i]
    kq = np.zeros((n, 4), np.float32)
    kt = np.zeros((n, 3), np.float32)
    kq[slots] = np.stack([p.q for p in poses])
    kt[slots] = np.stack([p.t for p in poses])
    order = slots.astype(np.int64)                         # slots in temporal order
    gt = jsyn.loop_trajectory(160, loop_frames=150, orbit_radius=0.4)
    drift = jsyn.pose(tx=0.01, rz=0.01)
    traj = [js3.mul(js3.SE3(np.asarray(drift.q, float), np.asarray(drift.t, float)),
                    js3.SE3(np.asarray(p.q, float), np.asarray(p.t, float))) for p in gt]
    for i in range(n):
        traj[10 * i] = poses[i]
    tq = np.stack([p.q for p in traj]).astype(np.float32)
    tt = np.stack([p.t for p in traj]).astype(np.float32)
    br = _brackets(np.arange(n) * 10, slots, 160)
    offs = [[0] * 6, [0.004, 0, 0, 0, 0.002, 0], [0, -0.003, 0, 0, 0, 0.002]]
    if not accept:
        offs[2] = [0.03, 0, 0, 0, 0, 0]
    rq, rt = _refinements(offs)
    # Refinements around the true cur_T_matched.
    base = js3.exp(np.array([0.3, -0.1, 0.2, 0.1, 0.4, -0.2]))
    fix = js3.mul(cur_T_matched, js3.inverse(base))
    for m in range(3):
        p = js3.mul(fix, js3.SE3(rq[m].astype(float), rt[m].astype(float)))
        rq[m], rt[m] = p.q, p.t
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-1, 1, 60), rng.uniform(-0.7, 0.7, 60),
                    rng.uniform(1.0, 3.0, 60)], -1).astype(np.float32)
    jcam = JCamera(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=128, height=96)

    padded = np.full(16, order[0], np.int32)
    padded[:n] = order
    j_out = jclosure.apply_closure(
        jnp.asarray(kq), jnp.asarray(kt), jnp.asarray(padded), jnp.int32(n), jnp.int32(15),
        jnp.int32(0), jnp.asarray(rq), jnp.asarray(rt), jnp.ones(3, bool),
        jnp.asarray(pts), jnp.ones(60, bool), jnp.asarray(tq), jnp.asarray(tt),
        *(jnp.asarray(a) for a in br), jnp.int32(0), jcam)
    # The port writes the store, the trajectory and the counter in place.
    state = [torch.from_numpy(a.copy()) for a in (kq, kt, tq, tt)]
    count = torch.zeros((), dtype=torch.int64)
    out = tclosure.apply_closure(
        state[0], state[1], torch.from_numpy(order), n, 15, 0, torch.from_numpy(rq),
        torch.from_numpy(rt), torch.ones(3, dtype=torch.bool), torch.from_numpy(pts),
        torch.ones(60, dtype=torch.bool), state[2], state[3],
        *(torch.from_numpy(a) for a in br), count, camera_from_numpy(jcam))
    assert bool(out.ok) == bool(j_out[5]) == accept
    assert int(j_out[4]) == int(count) == int(accept)
    if not accept:
        assert not bool(out.consistent) and bool(out.needed)
        for got, before in zip(state, (kq, kt, tq, tt)):
            assert torch.equal(got, torch.from_numpy(before))
        return
    out_kq, out_kt, out_tq, out_tt = state
    # Vertex 0 (slot order[0]) may differ by about residual / 1e4 under the
    # gauge prior: the JAX package's padded duplicates scatter either its
    # moved or its input value. Measured: 1.2e-7 on the keyframe poses,
    # 2.7e-7 on the trajectory.
    np.testing.assert_allclose(out_kq.numpy(), np.asarray(j_out[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out_kt.numpy(), np.asarray(j_out[1]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out_tq.numpy(), np.asarray(j_out[2]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out_tt.numpy(), np.asarray(j_out[3]), atol=1e-5, rtol=0)
    # The closure moved keyframe 15 onto keyframe 0's measurement.
    cur = js3.SE3(out_kq[slots[15]].double().numpy(), out_kt[slots[15]].double().numpy())
    m0 = js3.SE3(out_kq[slots[0]].double().numpy(), out_kt[slots[0]].double().numpy())
    err = np.linalg.norm(js3.log(js3.mul(js3.inverse(js3.mul(js3.inverse(cur), m0)), cur_T_matched))[:3])
    before = np.linalg.norm(js3.log(js3.mul(js3.inverse(js3.mul(js3.inverse(poses[15]), poses[0])),
                                            cur_T_matched))[:3])
    assert err < 0.2 * before


# ----------------------------------------------------------------------------
# The synthetic loop fixture
# ----------------------------------------------------------------------------


def test_loop_dataset_writer_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    cam_j, cam_t = jsyn.default_camera(48, 36), tsyn.default_camera(48, 36)
    gt_j = jsyn.loop_trajectory(4, loop_frames=3, orbit_radius=0.4)
    gt_t = tsyn.loop_trajectory(4, loop_frames=3, orbit_radius=0.4)
    for a, b in zip(gt_t, gt_j):
        np.testing.assert_array_equal(a.q, np.asarray(b.q))
        np.testing.assert_array_equal(a.t, np.asarray(b.t))
    rs_j, rs_t = jsyn.room_scene(3.5), tsyn.room_scene(3.5)
    np.testing.assert_array_equal(np.asarray(rs_t.normals), np.asarray(rs_j.normals))
    pts = np.random.default_rng(0).uniform(-2, 2, (100, 3))
    np.testing.assert_array_equal(tsyn.textured_intensity_at(pts, cell=0.07, seed=3),
                                  jsyn.textured_intensity_at(pts, cell=0.07, seed=3))
    opts = dict(depth_noise=0.004, depth_bias=0.01, depth_bias_quadratic=0.004,
                intensity_noise=2.0, noise_seed=4)
    jsyn.write_tum_dataset(str(tmp_path / "j"), cam_j, rs_j, gt_j,
                           albedo=lambda p: jsyn.textured_intensity_at(p, cell=0.07), **opts)
    tsyn.write_tum_dataset(str(tmp_path / "t"), cam_t, rs_t, gt_t,
                           albedo=lambda p: tsyn.textured_intensity_at(p, cell=0.07), **opts)
    for i in range(4):
        for kind in ("rgb", "depth"):
            a = read_png(str(tmp_path / "t" / kind / f"{i:05d}.png"))
            b = read_png(str(tmp_path / "j" / kind / f"{i:05d}.png"))
            np.testing.assert_array_equal(a, b)
    assert read_png(str(tmp_path / "t" / "rgb" / "00000.png")).std() > 10
