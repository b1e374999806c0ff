"""The port's keyframe store and surfel map against the JAX package.

The cases of tests/test_surfel_ops.py (160x120 rendered plane scenes,
tests/fixtures.py frames), with the same inputs given to both packages:
the JAX package's processed frames and poses go through
badslam_torch.convert, and where a step is held on its own, the port
starts from the JAX package's map and keyframes of that moment.

Tolerances:
  * surfel counts, valid and active flags, covisibility rows, activation
    states and freed keyframe slots: exact (integer and boolean outcomes
    of float tests that are far from their thresholds on these scenes);
  * pos / normal / radius2: atol 1e-5 (the same float32 formulas; XLA and
    PyTorch contract and order a few of them differently, which moves pos
    by an ulp);
  * desc: atol 5e-4. A descriptor is 180 x the difference of two bilinear
    intensity samples at tangent points of pos, so an ulp of pos times the
    image gradient shows there ~180-fold: measured up to 2.7e-4 at values
    up to ~19, i.e. 1.5e-6 in intensity units;
  * colors (0-255 scale, bilinear samples): atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.ba.scheme import DirectBA as JDirectBA
from badslam_tpu.config import BadSlamConfig as JConfig
from badslam_tpu.geometry import se3 as jse3
from badslam_tpu.mapping import keyframes as jkfs
from badslam_tpu.mapping import surfels as jsf
from badslam_tpu import synthetic as jsyn
from badslam_torch import convert
from badslam_torch.ba.scheme import DirectBA as TDirectBA
from badslam_torch.config import BadSlamConfig as TConfig
from badslam_torch.mapping import frustum
from badslam_torch.mapping import keyframes as tkfs
from badslam_torch.mapping import surfels as tsf

import fixtures

torch.set_num_threads(1)

CAP = 1 << 14
DEV = "cpu"
DESC_ATOL = 5e-4


class Pair:
    """The same DirectBA state in both packages."""

    def __init__(self, seed, **cfg):
        rng = np.random.default_rng(seed)
        self.jcam = jsyn.default_camera(160, 120)
        self.tcam = convert.camera_from_numpy(self.jcam)
        self.scene = jsyn.random_plane_scene(rng, 3)
        self.j = JDirectBA(self.jcam, JConfig(max_surfel_count=CAP, **cfg),
                           surfel_capacity=CAP)
        self.t = TDirectBA(self.tcam, TConfig(max_surfel_count=CAP, **cfg),
                           surfel_capacity=CAP, device=DEV)

    def add(self, pose, idx, scene=None):
        d, i = jsyn.render_scene(self.jcam, scene or self.scene, pose)
        f = fixtures.frame_from_render(self.jcam, d, i)
        kj = self.j.add_keyframe(f, pose, idx)
        kt = self.t.add_keyframe(convert.frame_from_numpy(f, DEV),
                                 convert.pose_from_numpy(pose.q, pose.t, DEV), idx)
        assert kj == kt
        return kj

    def create(self, kf, filter_new_surfels):
        cj = int(self.j.create_surfels_for_keyframe(kf, filter_new_surfels))
        ct = int(self.t.create_surfels_for_keyframe(kf, filter_new_surfels))
        assert cj == ct
        return cj

    def jmap_to_port(self):
        self.t.surfels = convert.surfel_map_from_numpy(self.j.surfels, DEV)

    def jstack(self, ids):
        return self.j.keyframes.stack(ids)

    def tstack(self, ids):
        return self.t.keyframes.stack(ids)


def assert_maps_equal(tm, jm, atol=1e-5):
    assert int(tm.count) == int(jm.count)
    tv, jv = tm.valid.numpy(), np.asarray(jm.valid)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tm.active.numpy() & tv, np.asarray(jm.active) & jv)
    for name, tol in (("pos", atol), ("normal", atol), ("radius2", atol),
                      ("desc", DESC_ATOL)):
        np.testing.assert_allclose(getattr(tm, name).numpy()[tv],
                                   np.asarray(getattr(jm, name))[jv],
                                   atol=tol, rtol=0, err_msg=name)
    np.testing.assert_allclose(tm.color.numpy()[tv], np.asarray(jm.color)[jv],
                               atol=1e-3, rtol=0)


def test_creation_matches_jax():
    p = Pair(21)
    kf0 = p.add(jse3.identity(), 0)
    created = p.create(kf0, False)
    assert created > 0.5 * (120 // 4) * (160 // 4)
    assert_maps_equal(p.t.surfels, p.j.surfels)


def test_creation_is_deduplicated_like_jax():
    p = Pair(22)
    kf0 = p.add(jse3.identity(), 0)
    first = p.create(kf0, False)
    second = p.create(kf0, False)
    assert second < 0.02 * first
    assert_maps_equal(p.t.surfels, p.j.surfels)


def test_observation_filter_rejects_unobserved_like_jax():
    p = Pair(23, min_observation_count_while_bootstrapping_2=2)
    kf0 = p.add(jse3.identity(), 0)
    far = jse3.mul(jsyn.pose(tx=50.0),
                   jse3.exp(jnp.array([0, 0, 0, 0.0, np.pi, 0.0], jnp.float32)))
    p.add(jse3.SE3(np.asarray(far.q), np.asarray(far.t)), 1)
    assert not bool(p.t.keyframes.covis[kf0, 1])
    assert p.create(kf0, True) == 0


def test_observation_filter_accepts_covisible_like_jax():
    p = Pair(24)
    kf0 = p.add(jse3.identity(), 0)
    p.add(jsyn.pose(tx=0.02), 1)
    assert bool(p.t.keyframes.covis[kf0, 1])
    assert p.create(kf0, True) > 500
    assert_maps_equal(p.t.surfels, p.j.surfels)


def test_merge_removes_duplicates_like_jax():
    p = Pair(25)
    kf0 = p.add(jse3.identity(), 0)
    p.create(kf0, False)
    n1 = p.j.surfel_count
    # Duplicate the map: hide the surfels (keeping count), create again,
    # then make both copies valid; the JAX package's state seeds the port.
    saved = p.j.surfels
    p.j.surfels = saved._replace(valid=jnp.zeros_like(saved.valid))
    p.j.create_surfels_for_keyframe(kf0, filter_new_surfels=False)
    dup = p.j.surfels
    p.j.surfels = dup._replace(valid=dup.valid | saved.valid)
    p.jmap_to_port()
    p.j._merge_surfels_masked(p.j.keyframes.mask_for_ids([kf0]))
    p.t.surfels = p.t._merge_surfels(p.t.surfels, [kf0])
    assert p.j.surfel_count == n1
    assert_maps_equal(p.t.surfels, p.j.surfels)


def test_compaction_matches_jax():
    p = Pair(26)
    kf0 = p.add(jse3.identity(), 0)
    p.create(kf0, False)
    m = p.j.surfels
    kill = jnp.array(np.random.default_rng(26).uniform(size=(m.capacity,)) < 0.33) & m.valid
    m = m._replace(valid=m.valid & ~kill,
                   count=m.count - jnp.sum(kill.astype(jnp.int32)))
    out_j = jsf.compact_surfels(m)
    out_t = tsf.compact_surfels(convert.surfel_map_from_numpy(m, DEV))
    count = int(out_j.count)
    assert out_t.valid[:count].all() and not out_t.valid[count:].any()
    # A permutation: every row moves exactly.
    for name in ("pos", "normal", "radius2", "desc", "color", "valid", "active"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)), err_msg=name)


def test_deletion_matches_jax():
    p = Pair(27)
    kf0 = p.add(jse3.identity(), 0)
    p.create(kf0, False)
    m = p.j.surfels
    phantom = jnp.arange(m.capacity) >= m.capacity - 64
    m = m._replace(
        pos=jnp.where(phantom[:, None], 100.0, m.pos),
        normal=jnp.where(phantom[:, None], jnp.array([0.0, 0.0, -1.0]), m.normal),
        valid=m.valid | phantom, count=m.count + 64)
    out_j = jsf.delete_surfels_and_update_radii(m, p.jcam, p.jstack([kf0]),
                                                jnp.int32(1), baseline_fx=40.0)
    out_t = tsf.delete_surfels_and_update_radii(
        convert.surfel_map_from_numpy(m, DEV), p.tcam, p.tstack([kf0]), 1,
        baseline_fx=40.0)
    assert int(out_t.count) == int(m.count) - 64
    assert_maps_equal(out_t, out_j)


def test_activation_matches_jax():
    p = Pair(28)
    kf0 = p.add(jse3.identity(), 0)
    p.add(jsyn.pose(tx=0.02, rz=0.01), 1)
    p.create(kf0, False)
    m = p.j.surfels._replace(active=jnp.zeros_like(p.j.surfels.active))
    for ids in ([kf0], [1], [0, 1]):
        out_j = jsf.update_surfel_activation(m, p.jcam, p.jstack(ids), 40.0)
        out_t = tsf.update_surfel_activation(convert.surfel_map_from_numpy(m, DEV),
                                             p.tcam, p.tstack(ids), 40.0)
        np.testing.assert_array_equal(out_t.active.numpy(), np.asarray(out_j.active))
    assert out_t.active.float().mean() > 0.05


def test_assign_colors_matches_jax():
    p = Pair(29)
    kf0 = p.add(jse3.identity(), 0)
    p.add(jsyn.pose(tx=0.02, ry=0.01), 1)
    p.create(kf0, False)
    out_j = jsf.assign_colors(p.j.surfels, p.jcam, p.j.keyframes.stack(),
                              p.j.keyframes.rgb, baseline_fx=40.0)
    out_t = tsf.assign_colors(p.t.surfels, p.tcam, p.t.keyframes.stack(),
                              p.t.keyframes.rgb[:p.t.keyframes.count], baseline_fx=40.0)
    assert_maps_equal(out_t, out_j)


def test_covisibility_and_activation_states_match_jax():
    """Covisibility rows of the SAT frustum test, the COVISIBLE_ACTIVE
    promotion on insertion, and _propagate_covisible_active."""
    p = Pair(30)
    scene_far = jsyn.PlaneScene(p.scene.points + np.array([50.0, 0, 0], np.float32),
                                p.scene.normals)
    poses = [jse3.identity(), jsyn.pose(tx=0.02), jsyn.pose(tx=50.0),
             jsyn.pose(tx=0.05, ry=0.3), jsyn.pose(tx=50.02, rz=0.2)]
    for i, pose in enumerate(poses):
        p.add(pose, i, scene=scene_far if i in (2, 4) else None)
    k = p.t.keyframes.count
    jk = p.j.keyframes
    np.testing.assert_array_equal(p.t.keyframes.covis[:k, :k].numpy(),
                                  np.asarray(jk.covis)[:k, :k])
    np.testing.assert_array_equal(p.t.keyframes.activation[:k].numpy(),
                                  np.asarray(jk.activation)[:k])
    assert p.t.keyframes.covis[:k, :k].sum() > 0 and not p.t.keyframes.covis[0, 2]
    rng = np.random.default_rng(30)
    for _ in range(4):
        act = rng.integers(0, 3, jk.capacity).astype(np.int32)
        valid = np.asarray(jk.valid).copy()
        valid[rng.integers(0, k)] = False
        out_j = jkfs._propagate_covisible_active(jk.covis, jnp.array(act), jnp.array(valid))
        out_t = tkfs.propagate_covisible_active(
            p.t.keyframes.covis[:k, :k], torch.from_numpy(act[:k]).long(),
            torch.from_numpy(valid[:k]))
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j)[:k])


def test_frustum_intersection_matches_jax():
    rng = np.random.default_rng(31)
    jcam = jsyn.default_camera(160, 120)
    q = rng.normal(size=(24, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(scale=1.5, size=(24, 3)).astype(np.float32)
    dmin = rng.uniform(0.3, 1.0, 24).astype(np.float32)
    dmax = (dmin + rng.uniform(0.5, 3.0, 24)).astype(np.float32)
    pts_j = np.asarray(jkfs._frustum_points(jcam, q, t, dmin, dmax))
    pts_t = frustum.frustum_points(convert.camera_from_numpy(jcam), *map(torch.from_numpy, (q, t, dmin, dmax)))
    np.testing.assert_allclose(pts_t.numpy(), pts_j, atol=1e-5, rtol=0)
    for i in range(24):
        want = [bool(jkfs._pair_intersects(pts_j[i], pts_j[j])) for j in range(24)]
        got = frustum.intersects(torch.from_numpy(pts_j[i])[None], torch.from_numpy(pts_j))
        assert got.tolist() == want
    assert 0 < sum(want) < 24


def test_merge_redundant_keyframes_matches_jax():
    p = Pair(32)
    for i in range(7):
        p.add(jsyn.pose(tx=0.01 * i, rz=0.002 * i), 10 * i)
    p.j.keyframes.remove_keyframe(3)
    p.t.keyframes.remove_keyframe(3)
    freed_j = p.j.keyframes.merge_redundant_keyframes(2)
    freed_t = p.t.keyframes.merge_redundant_keyframes(2)
    assert freed_t == freed_j and len(freed_t) == 2
    assert p.t.keyframes.free_slots == p.j.keyframes.free_slots
    # Freed slots are reused first, as there.
    kj = p.add(jsyn.pose(tx=0.09), 90)
    assert kj == freed_j[0] or kj == 3


@pytest.mark.parametrize("n", [0, 3])
def test_keyframe_store_round_trip(n):
    """convert.keyframe_store_from_numpy carries the whole store across."""
    p = Pair(33)
    for i in range(n):
        p.add(jsyn.pose(tx=0.01 * i), i)
    store = convert.keyframe_store_from_numpy(p.j.keyframes, p.tcam, DEV)
    assert store.count == p.t.keyframes.count == n
    for name in ("depth", "nx", "q", "t", "valid", "activation", "min_depth",
                 "max_depth", "rgb"):
        np.testing.assert_array_equal(getattr(store, name)[:n].numpy(),
                                      getattr(p.t.keyframes, name)[:n].numpy())
    np.testing.assert_array_equal(store.covis[:n, :n].numpy(),
                                  p.t.keyframes.covis[:n, :n].numpy())
