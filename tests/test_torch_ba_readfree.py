"""The port's fused BA call (badslam_torch/ba/scheme.py DirectBA._fused_program)
and its keyframe and surfel buckets on the CPU, against the JAX package's
fused BA programs.

* Read-free: the twin of tests/test_readfree.py:69 and :98. With the masked
  loop controls (the plain version of the card's WHILE nodes) and
  sync_surfel_bucket false, a keyframe frame (its steady frame, the new
  keyframe, the keyframe BA call and the trajectory deformation) and a
  chunk with its drain make no host read: every tensor-to-host conversion
  is patched to raise (test_torch_mapping.forbid_host_reads). The same
  frames with the host loops give the same poses (max |dq|, |dt| <= 1e-6),
  iterations and surfel count.
* Masked against host: the fused call, a keyframe call and then a drain
  that starts a new epoch, from the same state under the masked and the
  host controls: poses max |dq|, |dt| <= 1e-6; surfel count, valid flags
  and activation exact; the same iterations.
* Against the JAX package: both packages seeded with the same map and
  keyframes (badslam_torch.convert), a keyframe call and then a drain
  through the JAX package's DirectBA, whose fused branch runs
  _ba_iterations (the whole capacity) or _ba_iterations_bucketed (a bucket
  of the live keyframes) with _scheme_end_tasks, against the port's fused
  call on the CPU. Poses atol 1e-4 (the slice's hold); counts, valid and
  active flags, activation and the BA counters exact; positions, normals
  and radii atol 1e-5, descriptors 5e-4 (tests/test_torch_mapping.py's
  holds); the iterations equal to the `i` the JAX program returns; the
  surfel bound equal.
* Bucket arithmetic against the JAX package's host code: _bucket_size,
  _keyframe_bucket's slot list (with freed slots and its high-water mark)
  and prebudget_epochs, on the same host metadata (no compile).

96x80 planes scenes, one thread.
"""

import copy

import numpy as np
import pytest
import torch

from badslam_tpu import synthetic as jsyn
from badslam_tpu.ba import scheme as jscheme
from badslam_tpu.ba.scheme import DirectBA as JDirectBA
from badslam_tpu.config import BadSlamConfig as JConfig
from badslam_tpu.geometry import se3 as jse3
from badslam_torch import convert
from badslam_torch import synthetic as tsyn
from badslam_torch.ba.scheme import DirectBA as TDirectBA
from badslam_torch.config import BadSlamConfig as TConfig
from badslam_torch.frontend import BadSlam
from badslam_torch.io import dataset as tds
from badslam_torch.ops.conditional import HOST, MASKED

import fixtures
from test_torch_mapping import assert_maps_equal, forbid_host_reads

torch.set_num_threads(1)

W, H = 96, 80
CAP = 1 << 13
POSE_ATOL = 1e-4
EXACT_POSE_ATOL = 1e-6
# A surfel bucket below the capacity, so the calls work on a prefix.
CFG = dict(max_surfel_count=CAP, surfel_bucket_base=1024)


# ---------------------------------------------------------------------------
# The front end: a keyframe call, a chunk and its drain, read-free
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ba_readfree") / "seq")
    tsyn.write_tum_dataset(path, tsyn.default_camera(W, H),
                           tsyn.random_plane_scene(np.random.default_rng(3), 3),
                           tsyn.smooth_trajectory(9, scale=0.002))
    return path


def _slam(path):
    config = TConfig(num_scales=3, keyframe_interval=4, max_num_ba_iterations_per_keyframe=4,
                     tracking_max_iterations=8, enable_loop_detection=False,
                     fps_restriction=0, sync_surfel_bucket=False, **CFG)
    slam = BadSlam(config, tds.load_tum_dataset(path), "cpu")
    slam.process_frame(0)
    slam._process_chunk(1, 3, [])
    return slam


def _close(a, b, atol):
    return float((a - b).abs().max()) <= atol


def test_keyframe_call_and_chunk_drain_are_read_free(sequence):
    """Frame 4 (a keyframe: its BA call runs 2 iterations and queues 2) and
    frames 5-7 as a chunk whose drain runs the queued iterations in a call
    that starts a new epoch, on the masked controls: no host read, and the
    host loops' result."""
    masked, host = _slam(sequence), _slam(sequence)
    masked.ba_loop = masked.steady_loop = MASKED
    with pytest.MonkeyPatch.context() as mp:
        forbid_host_reads(mp)
        masked.process_frame(4)
        masked._process_chunk(5, 3, [])
    host.process_frame(4)
    host._process_chunk(5, 3, [])
    assert masked.ba_drain_frames == host.ba_drain_frames == [7]
    assert masked.queued_ba_iterations == host.queued_ba_iterations == 0
    assert _close(masked.traj_q, host.traj_q, EXACT_POSE_ATOL)
    assert _close(masked.traj_t, host.traj_t, EXACT_POSE_ATOL)
    assert masked.direct_ba.iterations_run == host.direct_ba.iterations_run
    assert len(host.direct_ba.iterations_run) == 2
    assert masked.direct_ba.surfel_count == host.direct_ba.surfel_count > 0


# ---------------------------------------------------------------------------
# The same state in both packages
# ---------------------------------------------------------------------------

GT = [jse3.identity(), jsyn.pose(tx=0.03, ty=0.01, rz=0.01),
      jsyn.pose(tx=-0.02, ty=0.02, rz=-0.01)]
PERT = jsyn.pose(tx=0.004, ty=-0.003, rz=0.001)


def _jax_state(seed, capacity):
    """The JAX package's DirectBA with 3 keyframes of a 96x80 plane scene in
    a store of `capacity` slots, keyframe 0's surfels made, keyframe 2
    perturbed."""
    rng = np.random.default_rng(seed)
    jcam = jsyn.default_camera(W, H)
    scene = jsyn.random_plane_scene(rng, 3)
    j = JDirectBA(jcam, JConfig(**CFG), surfel_capacity=CAP)
    j.keyframes._ensure_capacity(capacity)
    for i, pose in enumerate(GT):
        d, inten = jsyn.render_scene(jcam, scene, pose)
        j.add_keyframe(fixtures.frame_from_render(jcam, d, inten), pose, i)
    j.create_surfels_for_keyframe(0, filter_new_surfels=False)
    j.keyframes.set_pose(2, jse3.mul(GT[2], PERT))
    return j


def _port_of(j) -> TDirectBA:
    """The port's DirectBA holding the JAX package's state: map, keyframes,
    epoch and bucket state."""
    tcam = convert.camera_from_numpy(j.cam)
    t = TDirectBA(tcam, TConfig(**CFG), surfel_capacity=CAP, device="cpu")
    t.surfels = convert.surfel_map_from_numpy(j.surfels, "cpu")
    t.keyframes = convert.keyframe_store_from_numpy(j.keyframes, tcam, "cpu")
    t.keyframes._grow(j.keyframes.capacity)
    t.ba_iteration_count = j.ba_iteration_count
    t.last_ba_iteration_count = j.last_ba_iteration_count
    t.known_surfel_bound = t._creation_bound = j.known_surfel_bound
    t._bound_epoch = j._bound_epoch
    t._prebudgeted_epochs = j._prebudgeted_epochs
    t._kf_bucket_floor = j._kf_bucket_floor
    return t


@pytest.fixture(scope="module", params=[8, 16], ids=["whole_capacity", "bucketed"])
def jax_calls(request):
    """The JAX package's keyframe call (6 iterations allowed) and drain (2)
    from _jax_state, with the `i` of each fused program; and the port's
    DirectBA seeded with the state before them."""
    j = _jax_state(31, request.param)
    port = _port_of(j)
    returned = []

    def recording(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            returned.append(int(out[-1]))
            return out
        return run

    with pytest.MonkeyPatch.context() as mp:
        for name in ("_ba_iterations", "_ba_iterations_bucketed"):
            mp.setattr(jscheme, name, recording(getattr(jscheme, name)))
        sel = j._keyframe_bucket()
        j.bundle_adjustment(max_iterations=6)
        after_call = (j.surfels._replace(**{f: np.asarray(getattr(j.surfels, f))
                                            for f in j.surfels._fields}),
                      {n: np.asarray(getattr(j.keyframes, n)) for n in (
                          "q", "t", "activation", "last_active_iter", "last_covis_iter")},
                      j.known_surfel_bound)
        j.bundle_adjustment(max_iterations=2, increase_ba_iteration_count=False)
    assert (sel is None) == (request.param == 8)
    return port, j, after_call, returned


def _assert_store(tk, jk: dict, count):
    np.testing.assert_allclose(tk.q[:count].numpy(), jk["q"][:count], atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(tk.t[:count].numpy(), jk["t"][:count], atol=POSE_ATOL, rtol=0)
    for name in ("activation", "last_active_iter", "last_covis_iter"):
        np.testing.assert_array_equal(getattr(tk, name)[:count].numpy(), jk[name][:count],
                                      err_msg=name)


def test_fused_call_matches_jax(jax_calls):
    """The port's fused keyframe call and drain against the JAX package's
    programs on the same state."""
    port, j, (jmap, jstore, jbound), returned = jax_calls
    t = copy.deepcopy(port)
    iterations = t.bundle_adjustment(max_iterations=6)
    assert iterations == returned[0] and 1 < iterations < 6
    _assert_store(t.keyframes, jstore, 3)
    assert_maps_equal(t.surfels, jmap)
    assert t.known_surfel_bound == jbound
    drained = t.bundle_adjustment(max_iterations=2, increase_ba_iteration_count=False)
    assert drained == returned[1] and t.iterations_run == returned
    _assert_store(t.keyframes, {n: np.asarray(getattr(j.keyframes, n)) for n in jstore}, 3)
    assert_maps_equal(t.surfels, j.surfels)
    assert t.known_surfel_bound == j.known_surfel_bound
    assert t.surfel_bucket() == j._bucket_size(j.known_surfel_bound) < CAP


def test_masked_fused_call_equals_host_call(jax_calls):
    """The fused call under the masked controls gives the host loops'
    result: a keyframe call, then a drain that starts a new epoch."""
    port = jax_calls[0]
    host, masked = copy.deepcopy(port), copy.deepcopy(port)
    for kwargs in (dict(max_iterations=6), dict(max_iterations=2,
                                                increase_ba_iteration_count=False)):
        n_host = host.bundle_adjustment(loop=HOST, **kwargs)
        n_masked = masked.bundle_adjustment(loop=MASKED, **kwargs)
        assert isinstance(n_masked, torch.Tensor) and int(n_masked) == n_host
        hk, mk = host.keyframes, masked.keyframes
        assert _close(hk.q, mk.q, EXACT_POSE_ATOL) and _close(hk.t, mk.t, EXACT_POSE_ATOL)
        for name in ("activation", "last_active_iter", "last_covis_iter", "valid"):
            assert torch.equal(getattr(hk, name), getattr(mk, name)), name
        assert int(host.surfels.count) == int(masked.surfels.count) > 0
        assert torch.equal(host.surfels.valid, masked.surfels.valid)
    assert host.iterations_run == masked.iterations_run


# ---------------------------------------------------------------------------
# Bucket arithmetic (host code, no compile)
# ---------------------------------------------------------------------------


def _both(**cfg):
    jcam = jsyn.default_camera(32, 24)
    return (JDirectBA(jcam, JConfig(max_surfel_count=CAP, **cfg), surfel_capacity=CAP),
            TDirectBA(convert.camera_from_numpy(jcam), TConfig(max_surfel_count=CAP, **cfg),
                      surfel_capacity=CAP, device="cpu"))


@pytest.mark.parametrize("base", [1, 1000, 4096, 1 << 16])
def test_surfel_bucket_size_matches_jax(base):
    j, t = _both(surfel_bucket_base=base)
    for needed in (0, 1, 999, 1000, 1001, 4096, 5000, CAP - 1, CAP, CAP + 1, 10 * CAP):
        assert t._bucket_size(needed) == j._bucket_size(needed), needed


@pytest.mark.parametrize("base", [1, 4, 8])
def test_keyframe_bucket_matches_jax(base):
    """A growing store with freed slots: the slot list (live slots first,
    padded with distinct dead slots) and the high-water mark, call by call."""
    j, t = _both(keyframe_bucket_base=base)
    for ks in (j.keyframes, t.keyframes):
        ks._ensure_capacity(32)
    steps = [(1, []), (3, []), (5, [1]), (9, [1, 4]), (9, [1, 4, 6, 7, 8]), (12, [0, 5]),
             (16, [3]), (17, []), (2, [])]
    for count, free in steps:
        for ks in (j.keyframes, t.keyframes):
            ks.count, ks.free_slots = count, list(free)
        want = j._keyframe_bucket()
        got = t._keyframe_bucket()
        assert (got is None) == (want is None), (count, free)
        if want is not None:
            assert got == np.asarray(want).tolist()
            assert len(set(got)) == len(got)
        assert t._kf_bucket_floor == j._kf_bucket_floor


@pytest.mark.parametrize("epochs", [0, 1, 5, 19, 400])
def test_prebudget_epochs_matches_jax(epochs):
    j, t = _both()
    j.known_surfel_bound = t.known_surfel_bound = 700
    j.prebudget_epochs(epochs)
    t.prebudget_epochs(epochs)
    assert t.known_surfel_bound == j.known_surfel_bound
    assert t._prebudgeted_epochs == j._prebudgeted_epochs == epochs
