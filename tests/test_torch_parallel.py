"""The port's multi-device BA (badslam_torch.parallel) against the JAX
package's on the CPU.

The JAX side runs on the 8 virtual CPU devices tests/conftest.py forces;
the port on an 8-shard mesh on the one CPU device, from the same numpy
inputs. The scene is tests/test_parallel.py's (128x96, 8 keyframes,
capacity 1 << 13). Each function of badslam_torch/parallel/sharded.py and
streamed.py is held to its JAX twin and to the port's own one-device
stage, then DirectBA's integrated and streamed modes (a keyframe call and
a drain that starts a new epoch), the CLI with --n_devices 8 and the dry
run.

Tolerances (those of tests/test_torch_ba.py against the JAX package):
  * poses: atol 1e-4; normals and positions: atol 1e-4; descriptors:
    atol 2e-3; valid flags, created counts, merge results, the compaction
    order and delete counts: exact;
  * against the port's own one-device stages: poses atol 2e-5 (the psum of
    the single-pose Gauss-Newton adds the shards' H/b in another order;
    tests/test_parallel.py holds the JAX package to 2e-5 likewise),
    everything else exact.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu import parallel as jpar
from badslam_tpu.ba.scheme import DirectBA as JDirectBA
from badslam_tpu.cli import main as jax_main
from badslam_tpu.config import BadSlamConfig as JConfig
from badslam_tpu.geometry import se3 as jse3
from badslam_tpu.io.ply import load_ply
from badslam_tpu.parallel import streamed as jst
from badslam_tpu import synthetic as jsyn
from badslam_torch import convert
from badslam_torch import parallel as tpar
from badslam_torch import synthetic as tsyn
from badslam_torch.ba import geometry_opt as tgeo
from badslam_torch.ba import pose_opt as tpose
from badslam_torch.ba.scheme import DirectBA as TDirectBA
from badslam_torch.cli import run as torch_run
from badslam_torch.config import BadSlamConfig as TConfig
from badslam_torch.io import dataset as tds
from badslam_torch.mapping.keyframes import KeyframeStack
from badslam_torch.mapping import surfels as tsf
from badslam_torch.parallel.dryrun import dryrun_multichip

import fixtures

torch.set_num_threads(1)

CAP = 1 << 13
D = 8
POSE_ATOL = 1e-4
GEOM_ATOL = 1e-4
DESC_ATOL = 2e-3
OWN_POSE_ATOL = 2e-5
MIN_OBS = 6
GT = [jse3.identity(), jsyn.pose(tx=0.03, rz=0.01), jsyn.pose(tx=0.05, ty=0.02),
      jsyn.pose(ty=-0.03), jsyn.pose(tz=0.02), jsyn.pose(tx=-0.02, ry=0.01),
      jsyn.pose(ty=0.04, rx=-0.01), jsyn.pose(tx=0.01, tz=-0.02)]


class Scene:
    """tests/test_parallel.py's scene in both packages: 8 keyframes, the
    surfels of keyframe 0 (all active)."""

    def __init__(self):
        rng = np.random.default_rng(41)
        self.jcam = jsyn.default_camera(128, 96)
        self.tcam = convert.camera_from_numpy(self.jcam)
        scene = jsyn.random_plane_scene(rng, 3)
        self.j = JDirectBA(self.jcam, JConfig(max_surfel_count=CAP), surfel_capacity=CAP)
        self.t = TDirectBA(self.tcam, TConfig(max_surfel_count=CAP), surfel_capacity=CAP,
                           device="cpu")
        for i, g in enumerate(GT):
            d, inten = jsyn.render_scene(self.jcam, scene, g)
            f = fixtures.frame_from_render(self.jcam, d, inten)
            self.j.add_keyframe(f, g, i)
            self.t.add_keyframe(convert.frame_from_numpy(f, "cpu"),
                                convert.pose_from_numpy(g.q, g.t, "cpu"), i)
        self.j.create_surfels_for_keyframe(0, filter_new_surfels=False)
        self.j.surfels = self.j.surfels._replace(active=self.j.surfels.valid)
        self.jmap = self.numpy_map(self.j.surfels)
        self.jmesh = jpar.make_mesh(D)
        self.mesh = tpar.make_mesh(D, "cpu")
        self.streamed = tpar.Planes.of_store(self.mesh, self.t.keyframes, streamed=True)
        self.replicated = tpar.Planes.of_store(self.mesh, self.t.keyframes, streamed=False)

    @staticmethod
    def numpy_map(m):
        return m._replace(**{f: np.array(getattr(m, f)) for f in m._fields})

    def jax_map(self, m):
        """A fresh JAX map (the streamed stages donate theirs)."""
        return self.j.surfels._replace(**{f: jnp.array(getattr(m, f)) for f in m._fields})

    def port_map(self, m):
        return convert.surfel_map_from_numpy(m, "cpu")

    def perturbed(self):
        """Every keyframe pose off its truth by a few mm / mrad."""
        poses = [jse3.mul(g, jsyn.pose(tx=0.003 * ((i % 3) - 1), rz=0.001 * (i % 2)))
                 for i, g in enumerate(GT)]
        return (np.stack([np.asarray(p.q) for p in poses]).astype(np.float32),
                np.stack([np.asarray(p.t) for p in poses]).astype(np.float32))

    def noisy_map(self):
        """The map with each surfel moved along its normal by up to 4 mm."""
        m = self.jmap
        noise = 0.004 * np.random.default_rng(7).uniform(-1, 1, (CAP,)).astype(np.float32)
        return m._replace(pos=(m.pos + noise[:, None] * m.normal).astype(np.float32))

    def duplicated_map(self):
        """Keyframe 0's surfels twice, the copies 0.5 mm along the normal:
        every cell holds two surfels for the merge to resolve."""
        m = self.jmap
        n = int(m.count)
        out = {f: getattr(m, f).copy() for f in m._fields if f != "count"}
        for f in out:
            out[f][n:2 * n] = getattr(m, f)[:n]
        out["pos"][n:2 * n] += 0.0005 * m.normal[:n]
        return m._replace(count=np.int32(2 * n), **out)


@pytest.fixture(scope="module")
def scene():
    assert jax.device_count() >= D, "conftest must force 8 CPU devices"
    return Scene()


def _assert_poses(q, t, q_ref, t_ref, atol):
    q, q_ref = np.asarray(q, np.float64), np.asarray(q_ref, np.float64)
    sign = np.sign(np.sum(q * q_ref, axis=-1, keepdims=True))
    np.testing.assert_allclose(q * sign, q_ref, atol=atol, rtol=0, err_msg="q")
    np.testing.assert_allclose(np.asarray(t), np.asarray(t_ref), atol=atol, rtol=0,
                               err_msg="t")


def _assert_maps(tm, jm, exact_fields=("valid",)):
    """A port map against the JAX one at the module's holds."""
    assert int(tm.count) == int(jm.count)
    for f in exact_fields:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))
    v = np.asarray(jm.valid)
    for f, tol in (("pos", GEOM_ATOL), ("normal", GEOM_ATOL), ("desc", DESC_ATOL)):
        np.testing.assert_allclose(getattr(tm, f).numpy()[v], np.asarray(getattr(jm, f))[v],
                                   atol=tol, rtol=0, err_msg=f)


def _assert_same(a, b):
    """Two port maps equal in every field."""
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# parallel/sharded.py
# ---------------------------------------------------------------------------


def test_optimize_keyframe_poses_sharded(scene):
    q, t = scene.perturbed()
    jks = scene.j.keyframes.stack(list(range(D)))._replace(q=jnp.array(q), t=jnp.array(t))
    ref = jpar.optimize_keyframe_poses_sharded(scene.jmesh, scene.j.surfels, scene.jcam, jks)
    tks = convert.keyframe_stack_from_numpy(jks, "cpu")
    tmap = scene.port_map(scene.jmap)
    out = tpar.optimize_keyframe_poses_sharded(scene.mesh, tmap, scene.tcam, tks)
    own = tpose.optimize_keyframe_poses(tmap, scene.tcam, tks)
    _assert_poses(out.q, out.t, ref.q, ref.t, POSE_ATOL)
    _assert_poses(out.q, out.t, own.q, own.t, OWN_POSE_ATOL)
    assert torch.equal(out.moved, own.moved)
    np.testing.assert_array_equal(out.moved.numpy(), np.asarray(ref.moved))


@pytest.mark.parametrize("streamed", [False, True], ids=["replicated", "plane_streamed"])
@pytest.mark.parametrize("use_descriptor", [True, False], ids=["geo+photometric", "geometric"])
def test_optimize_geometry_sharded(scene, streamed, use_descriptor):
    jks = scene.j.keyframes.stack(list(range(D)))
    m = scene.noisy_map()
    jfn = jpar.optimize_geometry_plane_streamed if streamed else jpar.optimize_geometry_sharded
    tfn = tpar.optimize_geometry_plane_streamed if streamed else tpar.optimize_geometry_sharded
    ref = jfn(scene.jmesh, scene.jax_map(m), scene.jcam, jks, use_descriptor=use_descriptor)
    tks = convert.keyframe_stack_from_numpy(jks, "cpu")
    out = tfn(scene.mesh, scene.port_map(m), scene.tcam, tks, use_descriptor=use_descriptor)
    own = tgeo.optimize_geometry_iteration(scene.port_map(m), scene.tcam, tks,
                                           use_descriptor=use_descriptor)
    _assert_maps(out, ref)
    _assert_same(out, own)


def test_estimate_pose_sharded(scene):
    ks = scene.j.keyframes
    pert = jse3.mul(GT[1], jsyn.pose(tx=0.004, rz=0.002))
    jq, jt = jpar.estimate_pose_sharded(scene.jmesh, scene.j.surfels, scene.jcam, pert.q,
                                        pert.t, ks.depth[1], ks.nx[1], ks.ny[1],
                                        ks.intensity[1])
    tks = scene.t.keyframes
    tmap = scene.port_map(scene.jmap)
    q0, t0 = (torch.tensor(np.asarray(x), dtype=torch.float32) for x in (pert.q, pert.t))
    q, t = tpar.estimate_pose_sharded(scene.mesh, tmap, scene.tcam, q0, t0, tks.depth[1],
                                      tks.nx[1], tks.ny[1], tks.intensity[1])
    one = KeyframeStack(tks.depth[1:2], tks.nx[1:2], tks.ny[1:2], None,
                        tks.intensity[1:2], q0[None], t0[None], torch.ones(1, dtype=torch.bool))
    oq, ot = tpose._estimate_poses(tmap, scene.tcam, one, 40.0, True, True, 30)
    _assert_poses(q[None], t[None], np.asarray(jq)[None], np.asarray(jt)[None], POSE_ATOL)
    _assert_poses(q[None], t[None], oq, ot, OWN_POSE_ATOL)
    _assert_poses(q[None], t[None], np.asarray(GT[1].q)[None], np.asarray(GT[1].t)[None],
                  2e-4)


# ---------------------------------------------------------------------------
# parallel/streamed.py, both plane layouts
# ---------------------------------------------------------------------------


def _jplanes(scene, *names):
    ks = scene.j.keyframes
    return tuple(getattr(ks, n) for n in names)


def _planes(scene, streamed):
    return scene.streamed if streamed else scene.replicated


LAYOUTS = pytest.mark.parametrize("streamed", [True, False], ids=["streamed", "replicated"])


@LAYOUTS
def test_create_surfels_streamed(scene, streamed):
    jks, tks = scene.j.keyframes, scene.t.keyframes
    ids = [1, 2, 5]
    mask = np.zeros(D, bool)
    mask[ids] = True
    jmap, jcreated = jst.create_surfels_streamed(
        scene.jmesh, scene.jax_map(scene.jmap), scene.jcam,
        *_jplanes(scene, "depth", "nx", "ny", "radius2", "intensity", "rgb"),
        jks.q, jks.t, jnp.array(mask), jks.covis, jks.valid, jnp.int32(2),
        baseline_fx=40.0, cell_size=4)
    sm, created = tpar.create_surfels_streamed(
        scene.mesh, tpar.shard_rows(scene.mesh, scene.port_map(scene.jmap)), scene.tcam,
        _planes(scene, streamed), tks.q[:D], tks.t[:D], tks.mask_for_ids(ids), tks.covis,
        tks.valid, 2, baseline_fx=40.0, cell_size=4)
    out = tpar.gather_rows(scene.mesh, sm)
    own, own_created = tsf.create_surfels_for_keyframes(
        scene.port_map(scene.jmap), scene.tcam, tks.stack(), tks.mask_for_ids(ids),
        tks.covis, 2, 40.0, 4, rgb_stack=tks.rgb)
    assert int(created) == int(jcreated) == int(own_created) > 50
    _assert_maps(out, jmap, ("valid", "active"))
    _assert_same(out, own)


@LAYOUTS
@pytest.mark.parametrize("use_descriptor", [True, False], ids=["geo+photometric", "geometric"])
def test_activation_geometry_streamed(scene, streamed, use_descriptor):
    jks, tks = scene.j.keyframes, scene.t.keyframes
    m = scene.noisy_map()
    active = np.array([True, True, False, True, False, False, True, False])
    part = np.ones(D, bool)
    jout = jst.activation_geometry_streamed(
        scene.jmesh, scene.jax_map(m), scene.jcam,
        *_jplanes(scene, "depth", "nx", "ny", "intensity"), jks.q, jks.t,
        jnp.array(active), jnp.array(part), baseline_fx=40.0, use_depth=True,
        use_descriptor=use_descriptor, optimize_geometry=True)
    ta, tp = torch.from_numpy(active), torch.from_numpy(part)
    sm = tpar.activation_geometry_streamed(
        scene.mesh, tpar.shard_rows(scene.mesh, scene.port_map(m)), scene.tcam,
        _planes(scene, streamed), tks.q[:D], tks.t[:D], ta, tp, baseline_fx=40.0,
        use_depth=True, use_descriptor=use_descriptor, optimize_geometry=True)
    out = tpar.gather_rows(scene.mesh, sm)
    own = tgeo.update_activation_and_normals(scene.port_map(m), scene.tcam, tks.stack(),
                                             ta, tp, 40.0)
    own = tgeo._position_step(own, scene.tcam, tks.stack()._replace(mask=tp), 40.0, True,
                              use_descriptor)
    _assert_maps(out, jout, ("valid", "active"))
    _assert_same(out, own)


@LAYOUTS
def test_merge_and_compact_streamed(scene, streamed):
    jks, tks = scene.j.keyframes, scene.t.keyframes
    m = scene.duplicated_map()
    ids = [0, 1, 2, 3]
    mask = np.zeros(D, bool)
    mask[ids] = True
    jmerged = jst.merge_surfels_streamed(
        scene.jmesh, scene.jax_map(m), scene.jcam, *_jplanes(scene, "depth", "nx", "ny"),
        jks.q, jks.t, jnp.array(mask), baseline_fx=40.0, cell_size=4)
    sm = tpar.merge_surfels_streamed(
        scene.mesh, tpar.shard_rows(scene.mesh, scene.port_map(m)), scene.tcam,
        _planes(scene, streamed), tks.q[:D], tks.t[:D], tks.mask_for_ids(ids),
        baseline_fx=40.0, cell_size=4)
    merged = tpar.gather_rows(scene.mesh, sm)
    own = tsf.merge_surfels_for_keyframes(scene.port_map(m), scene.tcam, tks.stack(),
                                          tks.mask_for_ids(ids), 40.0, 4)
    assert int(m.count) - int(merged.count) > 100  # the copies merged
    _assert_maps(merged, jmerged, ("valid", "active"))
    _assert_same(merged, own)

    # Compaction of the JAX package's merged map in both: the same order.
    jm = scene.numpy_map(jmerged)
    jcompact = jst.compact_surfels_streamed(scene.jmesh, scene.jax_map(jm))
    sm = tpar.compact_surfels_streamed(scene.mesh,
                                       tpar.shard_rows(scene.mesh, scene.port_map(jm)))
    compact = tpar.gather_rows(scene.mesh, sm)
    for f in ("pos", "normal", "radius2", "desc", "valid", "active"):
        np.testing.assert_array_equal(getattr(compact, f).numpy(),
                                      np.asarray(getattr(jcompact, f)), err_msg=f)
    _assert_same(compact, tsf.compact_surfels(scene.port_map(jm)))


@LAYOUTS
def test_delete_surfels_streamed(scene, streamed):
    """Surfels seen by fewer than MIN_OBS of the 8 keyframes go."""
    jks, tks = scene.j.keyframes, scene.t.keyframes
    m = scene.noisy_map()
    jout = jst.delete_surfels_streamed(
        scene.jmesh, scene.jax_map(m), scene.jcam,
        *_jplanes(scene, "depth", "nx", "ny", "radius2"), jks.q, jks.t, jks.valid,
        jnp.int32(MIN_OBS), baseline_fx=40.0)
    sm = tpar.delete_surfels_streamed(
        scene.mesh, tpar.shard_rows(scene.mesh, scene.port_map(m)), scene.tcam,
        _planes(scene, streamed), tks.q[:D], tks.t[:D], tks.valid[:D], MIN_OBS,
        baseline_fx=40.0)
    out = tpar.gather_rows(scene.mesh, sm)
    own = tsf.delete_surfels_and_update_radii(scene.port_map(m), scene.tcam, tks.stack(),
                                              MIN_OBS, 40.0)
    assert 0 < int(m.count) - int(out.count) < int(m.count)
    _assert_maps(out, jout, ("valid", "active"))
    v = np.asarray(jout.valid)
    np.testing.assert_allclose(out.radius2.numpy()[v], np.asarray(jout.radius2)[v],
                               atol=1e-6, rtol=0)
    _assert_same(out, own)


@LAYOUTS
def test_optimize_poses_streamed(scene, streamed):
    jks, tks = scene.j.keyframes, scene.t.keyframes
    q, t = scene.perturbed()
    part = np.array([True, True, True, False, True, True, False, True])
    ref = jst.optimize_poses_streamed(
        scene.jmesh, scene.jax_map(scene.jmap), scene.jcam,
        *_jplanes(scene, "depth", "nx", "ny", "radius2", "intensity"),
        jnp.array(q), jnp.array(t), jnp.array(part), baseline_fx=40.0, use_depth=True,
        use_descriptor=True)
    tq, tt, tp = torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(part)
    tmap = scene.port_map(scene.jmap)
    out = tpar.optimize_poses_streamed(
        scene.mesh, tpar.shard_rows(scene.mesh, tmap), scene.tcam, _planes(scene, streamed),
        tq, tt, tp, baseline_fx=40.0, use_depth=True, use_descriptor=True)
    own = tpose.optimize_keyframe_poses(
        tmap, scene.tcam, tks.stack()._replace(q=tq, t=tt, mask=tp))
    _assert_poses(out.q, out.t, ref.q, ref.t, POSE_ATOL)
    _assert_poses(out.q, out.t, own.q, own.t, OWN_POSE_ATOL)
    np.testing.assert_array_equal(out.moved.numpy(), np.asarray(ref.moved))
    assert torch.equal(out.moved, own.moved)
    assert torch.equal(out.q[~tp], tq[~tp]) and torch.equal(out.t[~tp], tt[~tp])


def test_planes_layouts(scene):
    """Streamed: shard i holds the K/D slots it owns, as views of the store
    on its device; replicated: every shard all K."""
    ks = scene.t.keyframes
    for i in range(D):
        assert scene.streamed.keyframes_held(i) == ks.capacity // D
        assert scene.replicated.keyframes_held(i) == ks.capacity
        assert scene.streamed.owned(i) == (i, i + 1)
        assert scene.streamed.blocks["depth"][i].data_ptr() == ks.depth[i].data_ptr()
    per_slot = ks.depth[0].nbytes * 5 + ks.rgb[0].nbytes
    assert scene.streamed.nbytes(3) == per_slot
    assert scene.replicated.nbytes(3) == per_slot * ks.capacity
    for ids in ([2], [0, 1, 2], [1, 4, 7]):
        got = scene.streamed.take("intensity", torch.tensor(ids))
        assert len(got) == D and all(torch.equal(g, ks.intensity[ids]) for g in got)


# ---------------------------------------------------------------------------
# DirectBA's integrated and streamed modes
# ---------------------------------------------------------------------------


def _integrated_run(package, n_devices, budget):
    """tests/test_parallel.py's integrated run (96x72, two keyframes, the
    second off its truth, one BA call of 2 iterations) in either package."""
    rng = np.random.default_rng(13)
    cam = jsyn.default_camera(96, 72)
    scene = jsyn.random_plane_scene(rng, 3)
    gt = [jse3.identity(), jsyn.pose(tx=0.03, ty=0.01, rz=0.01)]
    pert = jse3.mul(gt[1], jsyn.pose(tx=0.004, ty=-0.003, rz=0.001))
    if package == "jax":
        ba = JDirectBA(cam, JConfig(max_surfel_count=CAP, n_devices=n_devices,
                                    plane_replication_budget_mb=budget),
                       surfel_capacity=CAP)
    else:
        ba = TDirectBA(convert.camera_from_numpy(cam),
                       TConfig(max_surfel_count=CAP, n_devices=n_devices,
                               plane_replication_budget_mb=budget),
                       surfel_capacity=CAP, device="cpu")
    for i, g in enumerate(gt):
        d, inten = jsyn.render_scene(cam, scene, g)
        f = fixtures.frame_from_render(cam, d, inten)
        p = pert if i else g
        if package == "jax":
            ba.add_keyframe(f, p, i)
        else:
            ba.add_keyframe(convert.frame_from_numpy(f, "cpu"),
                            convert.pose_from_numpy(p.q, p.t, "cpu"), i)
        if i == 0:
            ba.create_surfels_for_keyframe(0, filter_new_surfels=False)
    iterations = ba.bundle_adjustment(max_iterations=2)
    return ba, iterations


@pytest.mark.parametrize("budget", [2048.0, 0.0], ids=["integrated", "plane_streamed"])
def test_integrated_ba_matches_jax_and_single_device(budget):
    """config.n_devices=8: the port's BA call over an 8-shard CPU mesh
    against the JAX package's over its 8 CPU devices (and, with a budget of
    0 MB, both streaming the planes), and against the port on one device;
    a keyframe call, then a drain that starts a new epoch."""
    jba, _ = _integrated_run("jax", D, budget)
    tba, iters = _integrated_run("torch", D, budget)
    one, one_iters = _integrated_run("torch", 0, 2048.0)
    assert tba._streaming == (budget == 0.0) == jba._streaming
    if budget == 0.0:
        kl = tba.keyframes.capacity // D
        assert [tba._planes.keyframes_held(i) for i in range(D)] == [kl] * D
    assert iters == one_iters == 2
    k = 2
    _assert_poses(tba.keyframes.q[:k], tba.keyframes.t[:k], np.asarray(jba.keyframes.q)[:k],
                  np.asarray(jba.keyframes.t)[:k], POSE_ATOL)
    _assert_poses(tba.keyframes.q[:k], tba.keyframes.t[:k], one.keyframes.q[:k],
                  one.keyframes.t[:k], OWN_POSE_ATOL)
    assert tba.surfel_count == int(jba.surfels.count) == one.surfel_count > 100
    assert torch.equal(tba.surfels.valid, one.surfels.valid)

    # A drain of 2 iterations (the parallel-BA queue's call): it starts a
    # new epoch, so both packages first run the scheme-end tasks, then
    # their fused or streamed iterations.
    jba.bundle_adjustment(max_iterations=2, increase_ba_iteration_count=False)
    drained = tba.bundle_adjustment(max_iterations=2, increase_ba_iteration_count=False)
    one_drained = one.bundle_adjustment(max_iterations=2, increase_ba_iteration_count=False)
    assert drained == one_drained >= 1
    _assert_poses(tba.keyframes.q[:k], tba.keyframes.t[:k], np.asarray(jba.keyframes.q)[:k],
                  np.asarray(jba.keyframes.t)[:k], POSE_ATOL)
    _assert_poses(tba.keyframes.q[:k], tba.keyframes.t[:k], one.keyframes.q[:k],
                  one.keyframes.t[:k], OWN_POSE_ATOL)
    assert tba.surfel_count == int(jba.surfels.count) == one.surfel_count > 100
    assert torch.equal(tba.surfels.valid, one.surfels.valid)


def test_planes_follow_the_store():
    """Planes on another device than the store's are copies: a keyframe
    added after a BA call reaches its owner's copy at the next call, and
    growing the store re-splits the slots (ownership changes)."""
    jcam = jsyn.default_camera(32, 24)
    scene = jsyn.random_plane_scene(np.random.default_rng(4), 3)
    mesh = tpar.make_mesh(devices=["cpu", "meta"])
    ba = TDirectBA(convert.camera_from_numpy(jcam),
                   TConfig(max_surfel_count=1 << 10, keyframe_bucket_base=2,
                           n_devices=2, plane_replication_budget_mb=0.0),
                   surfel_capacity=1 << 10, device="cpu", mesh=mesh)
    frames = []
    for i in range(3):
        d, inten = jsyn.render_scene(jcam, scene, jsyn.pose(tx=0.01 * i))
        f = fixtures.frame_from_render(jcam, d, inten)
        frames.append(convert.frame_from_numpy(f, "cpu"))
    ba.add_keyframe(frames[0], tsyn.pose(), 0)
    planes = ba.mesh_planes(True)
    assert planes.kl == 1 and planes.blocks["depth"][1].device.type == "meta"
    ba.add_keyframe(frames[1], tsyn.pose(tx=0.01), 1)
    assert ba.mesh_planes(True) is planes and not ba.keyframes.changed_slots
    ba.add_keyframe(frames[2], tsyn.pose(tx=0.02), 2)  # grows the store to 4 slots
    grown = ba.mesh_planes(True)
    assert grown is not planes and grown.kl == 2
    assert grown.blocks["depth"][0].data_ptr() == ba.keyframes.depth.data_ptr()


def test_cuda_mesh_needs_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="n_devices=2 but only 1 CUDA"):
        tpar.make_mesh(2, "cuda")
    mesh = tpar.make_mesh(devices=["cuda:0", "cuda:0"])  # explicit: never a fallback
    assert mesh.devices == (torch.device("cuda", 0),) * 2
    assert tpar.make_mesh(3, "cpu").devices == (torch.device("cpu"),) * 3


# ---------------------------------------------------------------------------
# The slice as a whole, and the dry run
# ---------------------------------------------------------------------------

CLI_FRAMES = 9
CLI_FLAGS = ["--num_scales", "3", "--keyframe_interval", "4",
             "--max_num_ba_iterations_per_keyframe", "4",
             "--enable_loop_detection", "false", "--fps_restriction", "0",
             "--max_surfel_count", str(1 << 12), "--n_devices", str(D), "--quiet"]


@pytest.fixture(scope="module")
def cli_sequence(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("parallel") / "seq")
    cam = tsyn.default_camera(64, 48)
    scene = tsyn.random_plane_scene(np.random.default_rng(5), 6)
    tsyn.write_tum_dataset(data, cam, scene, tsyn.smooth_trajectory(CLI_FRAMES))
    return data


def _cli_outputs(tmp_path, tag):
    return str(tmp_path / f"{tag}.txt"), str(tmp_path / f"{tag}.ply")


@pytest.mark.parametrize("extra", [[], ["--plane_replication_budget_mb", "0"]],
                         ids=["integrated", "plane_streamed"])
def test_cli_n_devices_matches_jax_cli(cli_sequence, tmp_path, extra):
    """`python -m badslam_torch --device cpu --n_devices 8` against the JAX
    CLI with --n_devices 8 on its 8 CPU devices: the trajectory to 1e-4,
    the exported surfels equal in number."""
    jpose, jply = _cli_outputs(tmp_path, "jax")
    tpose_, tply = _cli_outputs(tmp_path, "torch")
    assert jax_main([cli_sequence, *CLI_FLAGS, *extra, "--export_poses", jpose,
                     "--export_point_cloud", jply]) == 0
    slam = torch_run([cli_sequence, "--device", "cpu", *CLI_FLAGS, *extra,
                      "--export_poses", tpose_, "--export_point_cloud", tply])
    assert slam.direct_ba.mesh.size == D
    assert slam.direct_ba._streaming == bool(extra)
    (_, pj), (_, pt) = tds.load_tum_trajectory(jpose), tds.load_tum_trajectory(tpose_)
    assert len(pj) == len(pt) == CLI_FRAMES
    _assert_poses(np.stack([p.q for p in pt]), np.stack([p.t for p in pt]),
                  np.stack([p.q for p in pj]), np.stack([p.t for p in pj]), POSE_ATOL)
    assert len(load_ply(tply)) == len(load_ply(jply)) > 100


def test_dryrun_multichip_on_the_cpu():
    out = dryrun_multichip(D)
    assert out["mesh"] == "Mesh(" + ", ".join(["cpu"] * D) + ")"
    assert out["poses_finite"] and out["geometry_finite"] and out["pose_gn_finite"]
    for mode in ("integrated", "streamed"):
        assert out[mode]["iterations"] == 2 and out[mode]["finite"]
        assert out[mode]["surfels"] > 0
