"""The port's BA call over a device mesh (badslam_torch/ba/scheme.py
DirectBA._fused_program with the stages of badslam_torch/parallel/streamed.py)
on the CPU, read-free.

* The call on an 8-shard CPU mesh, planes replicated (the keyframe bucket,
  4 of 8 slots) and streamed (the whole capacity, a slot per shard), a
  keyframe call of 2 iterations and then a drain of 1 that starts a new
  epoch (the front end's calls under parallel BA):
  - under the masked loop controls (the plain version of the card's WHILE
    nodes) it makes no host read: every tensor-to-host conversion is
    patched to raise (test_torch_mapping.forbid_host_reads);
  - masked against host: poses max |dq|, |dt| <= 1e-6; surfel count, valid
    flags and activation exact; the same iterations;
  - against the port's one-device fused call from the same state: poses
    atol 2e-5 (tests/test_torch_parallel.py's hold: the shards' blocks of
    the pose loops may batch other keyframes together); surfel count and
    valid flags exact.
* The front end on a 2-shard CPU mesh, planes streamed: a keyframe frame
  with its BA call and a chunk with its drain, read-free under the masked controls, and
  equal to the host loops (poses 1e-6, iterations, surfels).

The JAX package's mesh calls are held in tests/test_torch_parallel.py;
this file runs no JAX. 96x80 planes scenes, one thread.
"""

import copy

import numpy as np
import pytest
import torch

from badslam_torch import synthetic as tsyn
from badslam_torch.ba.scheme import DirectBA
from badslam_torch.config import BadSlamConfig
from badslam_torch.frontend import BadSlam
from badslam_torch.geometry import se3
from badslam_torch.io import dataset as tds
from badslam_torch.ops.conditional import HOST, MASKED
from badslam_torch.ops.preprocess import (
    ProcessedFrame,
    compute_normals,
    compute_radii_and_remove_isolated,
)

from test_torch_mapping import forbid_host_reads

torch.set_num_threads(1)

W, H = 96, 80
D = 8
CAP = 1 << 13
EXACT_POSE_ATOL = 1e-6
OWN_POSE_ATOL = 2e-5
# A surfel bucket below the capacity (the calls work on a prefix), and a
# store of SLOTS slots: the replicated call takes a bucket of 4.
SLOTS = 8
CFG = dict(max_surfel_count=CAP, surfel_bucket_base=1024, keyframe_bucket_base=4,
           sync_surfel_bucket=False)
LAYOUTS = {"replicated": 2048.0, "streamed": 0.0}
GT = [tsyn.pose(), tsyn.pose(tx=0.03, ty=0.01, rz=0.01),
      tsyn.pose(tx=-0.02, ty=0.02, rz=-0.01)]
PERT = tsyn.pose(tx=0.004, ty=-0.003, rz=0.001)


def _pose(p) -> se3.SE3:
    return se3.SE3(torch.from_numpy(p.q), torch.from_numpy(p.t))


def _frame(cam, depth, intensity) -> ProcessedFrame:
    """A keyframe's planes from a render (no bilateral smoothing)."""
    d, nx, ny = compute_normals(cam, torch.from_numpy(depth))
    d, r2 = compute_radii_and_remove_isolated(cam, d)
    keep = d > 0
    return ProcessedFrame(depth=d, nx=torch.where(keep, nx, 0.0),
                          ny=torch.where(keep, ny, 0.0), radius2=r2,
                          intensity=torch.from_numpy(intensity))


def _state(n_devices: int, budget: float) -> DirectBA:
    """3 keyframes of a 96x80 plane scene in a 16-slot store, keyframe 0's
    surfels made, keyframe 2 off its truth; BA over a CPU mesh of
    n_devices shards (none for 0)."""
    cam = tsyn.default_camera(W, H)
    scene = tsyn.random_plane_scene(np.random.default_rng(31), 3)
    ba = DirectBA(cam, BadSlamConfig(n_devices=n_devices,
                                     plane_replication_budget_mb=budget, **CFG),
                  surfel_capacity=CAP, device="cpu")
    ba.keyframes._ensure_capacity(SLOTS)
    for i, g in enumerate(GT):
        ba.add_keyframe(_frame(cam, *tsyn.render_scene(cam, scene, g)), _pose(g), i)
    ba.create_surfels_for_keyframe(0, filter_new_surfels=False)
    ba.keyframes.set_pose(2, se3.mul(_pose(GT[2]), _pose(PERT)))
    return ba


# The front end's calls with parallel BA: 2 iterations at a keyframe, then
# a drain of the queued ones.
CALLS = {"keyframe": dict(max_iterations=2),
         "drain": dict(max_iterations=1, increase_ba_iteration_count=False)}


def _calls(ba: DirectBA, loop, read_free: bool = False):
    """The keyframe call, then the drain that starts a new epoch: the state
    after each (a copy) and the iterations each returned."""
    out = {}
    for name, kwargs in CALLS.items():
        with pytest.MonkeyPatch.context() as mp:
            if read_free:
                forbid_host_reads(mp)
            iterations = ba.bundle_adjustment(loop=loop, **kwargs)
        out[name] = (copy.deepcopy(ba), iterations)
    return out


@pytest.fixture(scope="module", params=list(LAYOUTS))
def runs(request):
    """Per plane layout: the calls over the mesh under the host and the
    masked controls (the masked ones under forbid_host_reads), and on one
    device."""
    budget = LAYOUTS[request.param]
    return request.param, {"host": _calls(_state(D, budget), HOST),
                           "masked": _calls(_state(D, budget), MASKED, read_free=True),
                           "one": _calls(_state(0, budget), HOST)}


def _close(a, b, atol):
    return float((a - b).abs().max()) <= atol


@pytest.mark.parametrize("call", list(CALLS))
def test_mesh_call_runs_read_free_and_as_laid_out(runs, call):
    """The masked call made no host read (the fixture ran it under
    forbid_host_reads) and used the layout asked for."""
    layout, r = runs
    ba, iterations = r["masked"][call]
    assert isinstance(iterations, torch.Tensor)
    assert ba._streaming == (layout == "streamed")
    kl = ba.keyframes.capacity // D
    held = [ba._planes.keyframes_held(i) for i in range(D)]
    assert held == ([kl] * D if layout == "streamed" else [ba.keyframes.capacity] * D)
    if layout == "replicated":
        assert len(ba._keyframe_bucket()) == 4 < ba.keyframes.capacity


@pytest.mark.parametrize("call", list(CALLS))
def test_masked_mesh_call_equals_host_call(runs, call):
    _, r = runs
    (host, n_host), (masked, n_masked) = r["host"][call], r["masked"][call]
    assert int(n_masked) == n_host > 0
    hk, mk = host.keyframes, masked.keyframes
    assert _close(hk.q, mk.q, EXACT_POSE_ATOL) and _close(hk.t, mk.t, EXACT_POSE_ATOL)
    for name in ("activation", "last_active_iter", "last_covis_iter", "valid"):
        assert torch.equal(getattr(hk, name), getattr(mk, name)), name
    assert host.surfel_count == masked.surfel_count > 0
    assert torch.equal(host.surfels.valid, masked.surfels.valid)


@pytest.mark.parametrize("call", list(CALLS))
def test_mesh_call_matches_one_device(runs, call):
    _, r = runs
    (mesh, n_mesh), (one, n_one) = r["host"][call], r["one"][call]
    assert n_mesh == n_one
    assert _close(mesh.keyframes.q, one.keyframes.q, OWN_POSE_ATOL)
    assert _close(mesh.keyframes.t, one.keyframes.t, OWN_POSE_ATOL)
    assert mesh.surfel_count == one.surfel_count > 0
    assert torch.equal(mesh.surfels.valid, one.surfels.valid)


# ---------------------------------------------------------------------------
# The front end on a 2-shard mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_readfree") / "seq")
    tsyn.write_tum_dataset(path, tsyn.default_camera(W, H),
                           tsyn.random_plane_scene(np.random.default_rng(3), 3),
                           tsyn.smooth_trajectory(9, scale=0.002))
    return path


def _slam(path, budget):
    config = BadSlamConfig(num_scales=3, keyframe_interval=4,
                           max_num_ba_iterations_per_keyframe=4, tracking_max_iterations=8,
                           enable_loop_detection=False, fps_restriction=0,
                           n_devices=2,
                           plane_replication_budget_mb=budget, **CFG)
    slam = BadSlam(config, tds.load_tum_dataset(path), "cpu")
    slam.process_frame(0)
    slam._process_chunk(1, 3, [])
    return slam


def test_front_end_mesh_calls_are_read_free(sequence):
    """Frame 4 (a keyframe: its BA call over the mesh, planes streamed, runs
    2 iterations and queues 2) and frames 5-7 as a chunk whose drain runs
    the queued iterations, on the masked controls: no host read, and the
    host loops' result."""
    masked, host = _slam(sequence, 0.0), _slam(sequence, 0.0)
    masked.ba_loop = masked.steady_loop = MASKED
    with pytest.MonkeyPatch.context() as mp:
        forbid_host_reads(mp)
        masked.process_frame(4)
        masked._process_chunk(5, 3, [])
    host.process_frame(4)
    host._process_chunk(5, 3, [])
    assert masked.direct_ba.mesh.size == 2
    assert masked.direct_ba._streaming
    assert masked.ba_drain_frames == host.ba_drain_frames == [7]
    assert _close(masked.traj_q, host.traj_q, EXACT_POSE_ATOL)
    assert _close(masked.traj_t, host.traj_t, EXACT_POSE_ATOL)
    assert masked.direct_ba.iterations_run == host.direct_ba.iterations_run
    assert masked.direct_ba.surfel_count == host.direct_ba.surfel_count > 0
