"""The port's keyframe bundle adjustment against the JAX package.

The cases of tests/test_ba.py (160x120 rendered plane scenes, 2-3
keyframes), with the same frames and poses given to both packages; where
one step is held on its own, the port starts from the JAX package's map
and keyframes of that moment (badslam_torch.convert).

Tolerances:
  * surfel pose H / b: rtol 1e-4 with atol 1e-4 x the largest entry. Both
    sum the same float32 terms over ~2000 surfels, in another order;
    residual counts: exact;
  * poses after pose optimization, an iteration or a BA call: atol 1e-4
    (q and t in metres), the scheme's own convergence threshold
    (is_scale1_converged stops at steps of ~1e-3 m / 1e-4 rad, so two
    float orders may stop one step apart, well inside that);
  * normals and positions after a geometry step: atol 1e-4;
  * descriptors after a geometry step: atol 2e-3. They are 180 x an
    intensity difference solved jointly with the position (see
    test_torch_mapping.py's DESC_ATOL for the 180-fold reach of one ulp);
  * surfel counts, valid and active flags, activation states and the
    number of BA iterations: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.ba import geometry_opt as jgeo
from badslam_tpu.ba import pose_opt as jpose
from badslam_tpu.ba import scheme as jscheme
from badslam_tpu.geometry import se3 as jse3
from badslam_tpu import synthetic as jsyn
from badslam_torch import convert
from badslam_torch.ba import geometry_opt as tgeo
from badslam_torch.ba import pose_opt as tpose
from badslam_torch.geometry import se3 as tse3

import fixtures
from test_torch_mapping import DEV, Pair, assert_maps_equal

torch.set_num_threads(1)

POSE_ATOL = 1e-4
GEOM_ATOL = 1e-4
GEOM_DESC_ATOL = 2e-3
GT1 = jsyn.pose(tx=0.03, ty=0.01, rz=0.01)
PERT = jsyn.pose(tx=0.004, ty=-0.003, rz=0.001)


def two_keyframes(seed, perturb=True):
    """Keyframe 0 with its surfels, keyframe 1 at GT1 (times PERT)."""
    p = Pair(seed)
    kf0 = p.add(jse3.identity(), 0)
    p.create(kf0, False)
    kf1 = p.add(GT1, 1)
    if perturb:
        bad = jse3.mul(GT1, PERT)
        p.j.keyframes.set_pose(kf1, bad)
        p.t.keyframes.set_pose(kf1, convert.pose_from_numpy(
            np.asarray(bad.q), np.asarray(bad.t), DEV))
    return p, kf0, kf1


def assert_poses_close(t_store, j_store, atol=POSE_ATOL):
    k = t_store.count
    np.testing.assert_allclose(t_store.q[:k].numpy(), np.asarray(j_store.q)[:k],
                               atol=atol, rtol=0, err_msg="q")
    np.testing.assert_allclose(t_store.t[:k].numpy(), np.asarray(j_store.t)[:k],
                               atol=atol, rtol=0, err_msg="t")


@pytest.mark.parametrize("use_desc", [False, True], ids=["geometric", "geo+photometric"])
def test_surfel_pose_coeffs_matches_jax(use_desc):
    p, _, kf1 = two_keyframes(11)
    p.j.surfels = p.j.surfels._replace(active=p.j.surfels.valid)
    p.jmap_to_port()
    jk, tk = p.j.keyframes, p.t.keyframes
    Hj, bj, cj = jpose.surfel_pose_coeffs(
        p.j.surfels, p.jcam, jk.q[kf1], jk.t[kf1], jk.depth[kf1], jk.nx[kf1],
        jk.ny[kf1], jk.intensity[kf1], 40.0, True, use_desc)
    Ht, bt, ct = tpose.surfel_pose_coeffs(
        p.t.surfels, p.tcam, tk.q[kf1], tk.t[kf1], tk.depth[kf1], tk.nx[kf1],
        tk.ny[kf1], tk.intensity[kf1], 40.0, True, use_desc)
    assert int(ct) == int(cj) > 500
    for got, want in ((Ht, Hj), (bt, bj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("use_desc", [False, True], ids=["geometric", "geo+photometric"])
def test_optimize_keyframe_poses_matches_jax(use_desc):
    """Both packages recover the perturbed pose (test_ba.py's bound) and
    agree on it; the keyframe outside the mask passes through."""
    p, kf0, kf1 = two_keyframes(11)
    p.j.surfels = p.j.surfels._replace(active=p.j.surfels.valid)
    p.jmap_to_port()
    for pert in (PERT, jsyn.pose(ty=-0.005), jsyn.pose(rx=0.002)):
        bad = jse3.mul(GT1, pert)
        p.j.keyframes.set_pose(kf1, bad)
        p.t.keyframes.set_pose(kf1, convert.pose_from_numpy(
            np.asarray(bad.q), np.asarray(bad.t), DEV))
        rj = jpose.optimize_keyframe_poses(p.j.surfels, p.jcam, p.jstack([kf1]),
                                           use_descriptor=use_desc)
        rt = tpose.optimize_keyframe_poses(p.t.surfels, p.tcam, p.tstack([kf1]),
                                           use_descriptor=use_desc)
        k = p.t.keyframes.count
        np.testing.assert_allclose(rt.q.numpy(), np.asarray(rj.q)[:k], atol=POSE_ATOL, rtol=0)
        np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t)[:k], atol=POSE_ATOL, rtol=0)
        np.testing.assert_array_equal(rt.moved.numpy(), np.asarray(rj.moved)[:k])
        assert bool(rt.moved[kf1]) and not bool(rt.moved[kf0])
        np.testing.assert_array_equal(rt.q[kf0].numpy(), p.t.keyframes.q[kf0].numpy())
        err = float(torch.linalg.vector_norm(tse3.log(tse3.mul(
            tse3.inverse(tse3.SE3(rt.q[kf1], rt.t[kf1])),
            convert.pose_from_numpy(GT1.q, GT1.t, DEV)))))
        assert err < (5e-4 if use_desc else 2e-4), err


def test_scale1_convergence_matches_jax():
    rng = np.random.default_rng(43)
    x = (rng.normal(size=(64, 6)) * np.logspace(-8, -2, 64)[:, None]).astype(np.float32)
    want = [bool(jpose.is_scale1_converged(jnp.array(r))) for r in x]
    got = tpose.is_scale1_converged(torch.from_numpy(x)).tolist()
    assert got == want and 0 < sum(want) < 64


def test_update_activation_and_normals_matches_jax():
    p, kf0, kf1 = two_keyframes(44, perturb=False)
    p.add(jsyn.pose(tx=-0.02, ry=0.02), 2)
    p.jmap_to_port()
    k = p.t.keyframes.count
    active = np.array([True, False, False])
    participating = np.array([True, True, False])
    out_j = jgeo.update_activation_and_normals(
        p.j.surfels, p.jcam, p.jstack(range(k)),
        jnp.array(np.pad(active, (0, p.j.keyframes.capacity - k))),
        jnp.array(np.pad(participating, (0, p.j.keyframes.capacity - k))),
        baseline_fx=40.0)
    out_t = tgeo.update_activation_and_normals(
        p.t.surfels, p.tcam, p.tstack(range(k)), torch.from_numpy(active),
        torch.from_numpy(participating), baseline_fx=40.0)
    np.testing.assert_array_equal(out_t.active.numpy(), np.asarray(out_j.active))
    assert out_t.active.float().sum() > 500
    np.testing.assert_allclose(out_t.normal.numpy(), np.asarray(out_j.normal),
                               atol=GEOM_ATOL, rtol=0)


@pytest.mark.parametrize("use_desc", [False, True], ids=["pos1d", "pos3d"])
def test_position_step_matches_jax(use_desc):
    """test_ba.py's geometry case: positions pushed off the surface along
    their normals come back, in both packages alike."""
    p, kf0, kf1 = two_keyframes(12, perturb=False)
    m = p.j.surfels._replace(active=p.j.surfels.valid)
    original = np.asarray(m.pos)
    noise = 0.005 * jnp.array(np.random.default_rng(5).uniform(-1, 1, (m.capacity,)),
                              jnp.float32)
    m = m._replace(pos=m.pos + noise[:, None] * m.normal)
    mt = convert.surfel_map_from_numpy(m, DEV)
    # The port reads the JAX package's own keyframe stack (full capacity,
    # masked), carried across by convert.
    tstack = convert.keyframe_stack_from_numpy(p.jstack([kf0, kf1]), DEV)
    for _ in range(3):
        m = jgeo._position_step(m, p.jcam, p.jstack([kf0, kf1]), baseline_fx=40.0,
                                use_depth=True, use_descriptor=use_desc)
        mt = tgeo._position_step(mt, p.tcam, tstack, baseline_fx=40.0,
                                 use_depth=True, use_descriptor=use_desc)
    valid = np.asarray(m.valid)
    np.testing.assert_allclose(mt.pos.numpy()[valid], np.asarray(m.pos)[valid],
                               atol=GEOM_ATOL, rtol=0)
    np.testing.assert_allclose(mt.desc.numpy()[valid], np.asarray(m.desc)[valid],
                               atol=GEOM_DESC_ATOL, rtol=0)
    err = np.linalg.norm(mt.pos.numpy()[valid] - original[valid], axis=-1)
    assert err.mean() < 1e-4, err.mean()


def test_optimize_geometry_iteration_matches_jax():
    p, kf0, kf1 = two_keyframes(12, perturb=False)
    m = p.j.surfels._replace(active=p.j.surfels.valid)
    out_j = jgeo.optimize_geometry_iteration(m, p.jcam, p.jstack([kf0, kf1]))
    out_t = tgeo.optimize_geometry_iteration(convert.surfel_map_from_numpy(m, DEV),
                                             p.tcam, p.tstack([kf0, kf1]))
    valid = np.asarray(out_j.valid)
    for name, tol in (("pos", GEOM_ATOL), ("normal", GEOM_ATOL), ("desc", GEOM_DESC_ATOL)):
        np.testing.assert_allclose(getattr(out_t, name).numpy()[valid],
                                   np.asarray(getattr(out_j, name))[valid],
                                   atol=tol, rtol=0, err_msg=name)


def _jax_iteration(ba, statics_from):
    """One JAX _ba_iteration on `ba`'s state, as its per-iteration loop
    calls it; updates `ba` in place."""
    c = ba.config
    ks = ba.keyframes
    (ba.surfels, ks.q, ks.t, ks.activation, ks.last_active_iter,
     ks.last_covis_iter) = jscheme._ba_iteration(
        ba.surfels, ba.cam, ks.depth, ks.nx, ks.ny, ks.radius2, ks.intensity,
        ks.rgb, ks.q, ks.t, ks.valid, ks.activation, ks.last_active_iter,
        ks.last_covis_iter, ks.covis, jnp.int32(ba.ba_iteration_count),
        jnp.int32(ba.min_observation_count()), baseline_fx=c.baseline_fx,
        cell_size=c.sparse_surfel_cell_size,
        merge_dist_factor=c.surfel_merge_dist_factor,
        use_depth=c.use_geometric_residuals,
        use_descriptor=c.use_photometric_residuals, optimize_geometry=True,
        do_surfel_updates=True, optimize_poses=True, pose_iterations=30)


def _seed_port_from_jax(p):
    p.t.surfels = convert.surfel_map_from_numpy(p.j.surfels, DEV)
    p.t.keyframes = convert.keyframe_store_from_numpy(p.j.keyframes, p.tcam, DEV)
    p.t.ba_iteration_count = p.j.ba_iteration_count


def test_iteration_core_matches_jax():
    """One alternating-BA iteration from the JAX package's exact map and
    keyframes: creation for the newly active keyframe, activation, normals,
    positions, merge, compaction, poses and re-activation."""
    p, kf0, kf1 = two_keyframes(13)
    p.add(jsyn.pose(tx=0.01, ty=0.02, rz=-0.01), 2)
    _seed_port_from_jax(p)
    k = p.t.keyframes.count
    _jax_iteration(p.j, None)
    smap = p.t._iteration(p.t._working_map(k), activate_all=False,
                          optimize_geometry=True, do_surfel_updates=True,
                          optimize_poses=True)
    assert int(smap.count) == p.j.surfel_count > 500
    jk, tk = p.j.keyframes, p.t.keyframes
    assert_poses_close(tk, jk)
    for name in ("activation", "last_active_iter", "last_covis_iter"):
        np.testing.assert_array_equal(getattr(tk, name)[:k].numpy(),
                                      np.asarray(getattr(jk, name))[:k], err_msg=name)
    tv = smap.valid.numpy()
    np.testing.assert_array_equal(tv, np.asarray(p.j.surfels.valid)[:tv.size])
    np.testing.assert_allclose(smap.pos.numpy()[tv],
                               np.asarray(p.j.surfels.pos)[:tv.size][tv],
                               atol=GEOM_ATOL, rtol=0)


def test_scheme_end_tasks_match_jax():
    """PerformBASchemeEndTasks from the JAX package's exact state: the
    final merge over the epoch's active keyframes, deletion of surfels
    with too few observations, compaction."""
    p, kf0, kf1 = two_keyframes(48, perturb=False)
    # Surfels of keyframe 1 too, so that the merge has duplicates to fold,
    # and some far-off phantoms that no keyframe observes, for deletion,
    # appended after the live surfels as creation appends them.
    p.j.create_surfels_for_keyframe(kf1, filter_new_surfels=False)
    m = p.j.surfels
    n = int(m.count)
    phantom = (jnp.arange(m.capacity) >= n) & (jnp.arange(m.capacity) < n + 32)
    p.j.surfels = m._replace(
        pos=jnp.where(phantom[:, None], 100.0, m.pos), valid=m.valid | phantom,
        count=m.count + 32)
    la = np.asarray(p.j.keyframes.last_active_iter).copy()
    la[:2] = p.j.ba_iteration_count
    p.j.keyframes.last_active_iter = jnp.array(la)
    _seed_port_from_jax(p)
    before = p.j.surfel_count
    p.j.perform_ba_scheme_end_tasks(True)
    p.t.perform_ba_scheme_end_tasks(True)
    assert p.t.surfel_count == p.j.surfel_count < before - 32
    assert_maps_equal(p.t.surfels, p.j.surfels)


def test_bundle_adjustment_recovers_perturbation_like_jax():
    """test_ba.py's full-scheme case: the perturbed keyframe's relative pose
    improves five-fold in both packages, they agree on every pose, on the
    surfel count and on the number of iterations run (the early exit once
    no keyframe is ACTIVE)."""
    p, kf0, kf1 = two_keyframes(13)
    gt = [jse3.identity(), GT1]
    jerr0 = fixtures.relative_pose_error(jse3, p.j.keyframes.pose(kf0),
                                         p.j.keyframes.pose(kf1), *gt)
    # convergence_check: the JAX package's host loop, which reports the
    # iterations it ran; its exit test is the fused while_loop's.
    iters_j = p.j.bundle_adjustment(max_iterations=8, convergence_check=True)
    iters_t = p.t.bundle_adjustment(max_iterations=8)
    assert iters_t == iters_j and p.t.iterations_run == [iters_j]
    assert 1 < iters_t < 8
    assert_poses_close(p.t.keyframes, p.j.keyframes)
    assert p.t.surfel_count == p.j.surfel_count > 500
    np.testing.assert_array_equal(p.t.keyframes.activation[:2].numpy(),
                                  np.asarray(p.j.keyframes.activation)[:2])
    tk = p.t.keyframes
    terr = fixtures.relative_pose_error(
        tse3, tk.pose(kf0), tk.pose(kf1),
        *(convert.pose_from_numpy(g.q, g.t, DEV) for g in gt))
    assert terr < jerr0 / 5, (jerr0, terr)
