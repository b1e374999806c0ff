"""badslam_torch on the card: the CUDA kernels (K1 bilateral filter, K2
image gather, K3 one-hot gather, H1 the tracker's Gauss-Newton step, H2
BA's pose accumulation, H3 BA's geometry pass) against their plain PyTorch
versions, and the CUDA path against the CPU path of the same modules.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so on a GPU machine without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances:
  * K2 and K3 vs plain version: exact (a gather computes nothing).
  * K1 vs plain version: atol 1e-5 (depths of 0.5-3 m; sums in the same
    order and IEEE reciprocals in both; the kernel's exponential is
    ex2.approx, within 2 ulp, which tests/test_torch_bilateral.py shows
    moves the output by ~1e-6 at most).
  * K1 with each of its tiles vs the default tile: exact (every tile sums
    an output's taps in the same order).
  * preprocess on CUDA vs CPU: atol 1e-5 on depths, 1e-4 on normals (the
    normals amplify the depths' ~1e-6 differences, as against JAX).
  * tracked pose on CUDA vs CPU: atol 1e-4, the slice's hold.
  * bundle adjustment on CUDA vs CPU: keyframe poses atol 1e-4, the same
    number of iterations, surfel counts within 1% (creation and deletion
    are threshold tests on float values).
  * H1 (the tracker's Gauss-Newton step) vs its plain chain on the card,
    at 640x480, 739x458 and their coarsest levels 40x30 and 46x28, for
    depth and descriptor, depth, descriptor and gradient-magnitude
    residuals: H and b within 1e-5 of each one's largest entry, counts
    exact, the cost within 1e-5 relative (float32 both; the per-pixel
    terms are the same operations, the sums run in another order), two
    launches bit for bit; one whole step's q and t within 1e-6 and the same
    convergence flag, in place the same bits; the duel's pick equal; the
    coarse-to-fine tracker at 640x480 the same iterations per scale and
    poses within 1e-5.
  * H3 (BA's geometry pass) vs its plain chain on the card, at 640x480 and
    739x458, 131,072 rows 10% live, keyframe stacks of 1, 8 and 11 slots
    with masks that leave some out: bit for bit (activation flags,
    observation counts, normal sums, each row's position system after
    every block, normals, positions, descriptors; the kernel repeats each
    plain operation as PyTorch rounds it on the card, its sums over the
    slots in torch.sum's order), the same bits on a repeated launch; the
    sharded geometry step over 2 shards of the card against one device:
    bit for bit. A BA call on the card runs neither H2's nor H3's plain
    chain.
  * H2 (BA's pose accumulation) vs its plain version on the card, 640x480
    planes, 131,072 surfel rows 10% live: H and b rtol 1e-5 with atol 1e-5
    x the keyframe's largest entry (float32 both; the per-surfel terms are
    the same operations, the sums run in another order), counts exact,
    keyframes outside the running mask exactly 0, two launches bit for
    bit; the pose Gauss-Newton loops with H2 and with the plain version
    from one state: the same steps per keyframe, poses atol 1e-6 after one
    step and 5e-5 after the loop (later steps associate at the moved
    poses, where a pixel edge makes a rounding-sized difference one
    surfel's share; the plain version's rows summed in another order on
    the CPU move this state's poses by up to 1.2e-5 m).
  * a loop closure's gates, pose graph and deformation on CUDA vs CPU:
    poses and trajectory atol 1e-5, the same decisions.
  * a live directory stream through run_live on CUDA vs CPU: poses atol
    1e-4, surfel counts within 1%.
  * BA's timing rows under sync_stage_profiling on CUDA vs CPU: the same
    keys in the same order; the device ATE on the card against the host
    metric: 1e-6 relative; timed regions (CUDA events) without a stage
    sync: no synchronization of the card while the regions run.
  * multi-device BA on a 2-shard mesh on the card against a 2-shard mesh
    on the CPU, from the same keyframes and map (made on the CPU): each
    stage function of badslam_torch.parallel in turn (poses, positions and
    normals atol 1e-4, descriptors atol 2e-3: tests/test_torch_ba.py's
    holds for another float order; surfel counts within 1%), and
    DirectBA's integrated and streamed calls (poses atol 1e-4, the same
    iterations, surfel counts within 1%).
  * the steady frame's CUDA graph replays against the eager call of the
    same function with the host-read loop on the card: poses atol 1e-6
    (the same kernels on the same inputs; measured 0), the same
    Gauss-Newton iterations and the same launches; the same at the ETH3D
    SLAM camera's 739x458, with the preprocessing stamp run once a replay.
  * the fused BA call's CUDA graph replays against the eager call of the
    same function with the host loops on the card: poses atol 1e-6, the
    same iterations, surfel counts and K2 launches; replays make no sync
    with sync_surfel_bucket false; a bucket change captures anew. The same
    over a 2-shard mesh of the card, planes replicated and streamed, with
    the K2 launches equal per shard.
  * a loop-closure attempt's CUDA graph replay against the eager call of
    the same function with the host loop on the card: poses and trajectory
    atol 1e-6, the same gates and K2 launches, a rejection bit-identical;
    replays make no sync.
  * device stamps: a stamped WHILE body's runs exact, its device time and
    the replay's within 5% of CUDA events around the replays; a run with
    the stamps and without: trajectory, keyframe poses and map bit for bit,
    the same stream syncs and copies; the steady replays' first stamp
    kernel within 20 us of its globaltimer mapped onto the profiler's
    clock; no stage range inside a capture's range.
"""

import functools
import json

import numpy as np
import pytest
import torch

from badslam_torch import synthetic
from badslam_torch.ba import pose_opt
from badslam_torch.geometry.camera import PinholeCamera
from badslam_torch.ops import autotune as tuner
from badslam_torch.ops import kernels
from badslam_torch.ops.preprocess import bilateral_filter_and_cutoff, preprocess_frame
from badslam_torch.ops.pyramid import build_pyramid
from badslam_torch.tracking import pairwise
from badslam_torch.tracking.pairwise import track_frame_pairwise


@pytest.fixture
def cuda(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # An empty tuning store: one left by an earlier --autotune run must not
    # pick K1's tile here.
    monkeypatch.setattr(tuner, "_TUNING_PATH", str(tmp_path / "tuning.json"))
    monkeypatch.setattr(tuner, "_cache", {})
    return torch.device("cuda")


def _depth(seed, shape, max_depth=2.5):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    d[rng.uniform(size=shape) < 0.15] = 0.0
    d[rng.uniform(size=shape) < 0.05] = max_depth + 2.0
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (67, 160), (5, 3), (1, 1), (33, 70), (458, 739)])
def test_bilateral_kernel_matches_plain(cuda, shape):
    d = torch.from_numpy(_depth(sum(shape), shape)).to(cuda)
    before = kernels.launch_counts[kernels.BILATERAL]
    out = kernels.bilateral_filter(d, 2.5)
    torch.cuda.synchronize()
    assert kernels.launch_counts[kernels.BILATERAL] == before + 1
    ref = bilateral_filter_and_cutoff(d, 2.5)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_bilateral_kernel_radius_and_sigma(cuda):
    """Radii 2-5 (3 is the unrolled instance, the others the run-time-radius
    one) on ragged shapes: heights that are not a multiple of the 2 rows per
    thread or the 16-row tile, widths that are not a multiple of the
    32-column tile, rows that are 16-byte aligned (width % 4 == 0) and
    rows that are not (scalar loads only)."""
    for shape in ((50, 90), (37, 68), (3, 44)):
        d = torch.from_numpy(_depth(sum(shape), shape, 4.0)).to(cuda)
        for sigma_xy, radius_factor, sigma_inv in ((1.0, 2.0, 0.01), (1.5, 2.0, 0.005),
                                                   (2.0, 2.0, 0.005), (2.5, 2.0, 0.005)):
            out = kernels.bilateral_filter_and_cutoff_cuda(d, 4.0, sigma_xy, radius_factor, sigma_inv)
            ref = bilateral_filter_and_cutoff(d, 4.0, sigma_xy, radius_factor, sigma_inv)
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_bilateral_kernel_on_rendered_frame(cuda):
    """The input the main path gives K1: a rendered VGA frame, raw u16
    depth scaled to metres, smooth and almost all valid."""
    cam = synthetic.default_camera(640, 480)
    scene = synthetic.random_plane_scene(np.random.default_rng(7), 6)
    depth, _ = synthetic.render_scene(cam, scene, synthetic.pose(tx=0.01, rz=0.02))
    raw = torch.from_numpy(np.clip(depth * 5000.0, 0, 65535).astype(np.int32))
    d = (raw.to(torch.float32) * (1.0 / 5000.0)).to(cuda)
    out = kernels.bilateral_filter(d, 3.0)
    ref = bilateral_filter_and_cutoff(d, 3.0)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert float((ref > 0).float().mean()) > 0.9
    info = kernels.bilateral_launch_info(480, 640, 3)
    assert (info["grid_x"], info["grid_y"], info["threads"]) == (20, 30, 256)
    assert info["registers"] > 0 and info["blocks_per_sm"] > 0 and info["sms"] > 0


@pytest.mark.cuda
def test_bilateral_kernel_rejects_what_it_does_not_take(cuda):
    d = torch.from_numpy(_depth(4, (20, 30))).to(cuda)
    with pytest.raises(ValueError):
        kernels.bilateral_filter_and_cutoff_cuda(d.double(), 2.5)
    with pytest.raises(ValueError):
        kernels.bilateral_filter_and_cutoff_cuda(d.t(), 2.5)
    with pytest.raises(ValueError):
        kernels.bilateral_filter_and_cutoff_cuda(d.cpu(), 2.5)
    with pytest.raises(ValueError, match="no tile"):
        kernels.bilateral_filter_and_cutoff_cuda(d, 2.5, tile=(3, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (67, 160), (502, 670)])
def test_bilateral_tiles_give_the_default_tiles_bits(cuda, shape):
    """Every tile of K1's table, at radius 0, 3 (the unrolled instance)
    and 16 (the largest), against the default tile (bit for bit) and the
    plain version (1e-5); each launch counted under its tile."""
    tiles = kernels.bilateral_tiles()
    assert tiles == [(8, 2), (8, 1)]  # the default first
    d = torch.from_numpy(_depth(sum(shape), shape)).to(cuda)
    for sigma_xy in (0.2, 1.5, 8.0):  # radius int(2 sigma + 0.5): 0, 3, 16
        ref = bilateral_filter_and_cutoff(d, 2.5, sigma_xy)
        default = kernels.bilateral_filter_and_cutoff_cuda(d, 2.5, sigma_xy, tile=tiles[0])
        for tile in tiles:
            before = kernels.launch_shapes[kernels.BILATERAL][(*shape, tile)]
            out = kernels.bilateral_filter_and_cutoff_cuda(d, 2.5, sigma_xy, tile=tile)
            torch.cuda.synchronize()
            assert kernels.launch_shapes[kernels.BILATERAL][(*shape, tile)] == before + 1
            assert torch.equal(out, default), (tile, sigma_xy)
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_autotuned_tile_serves_later_launches(cuda):
    """autotune_bilateral_tile stores the winner under the card's name
    and the size; the next default launch at that size takes it, another
    size the default tile, and a stored tile the kernel lacks raises."""
    tile = kernels.autotune_bilateral_tile(120, 160, max_depth=3.0, device=cuda)
    tiles = kernels.bilateral_tiles()
    assert tile in tiles and set(tuner.last_times) == set(map(kernels.tile_name, tiles))
    key = tuner.device_key("bilateral_120x160", cuda)
    assert key == f"{torch.cuda.get_device_name(cuda)}:bilateral_120x160"
    with open(tuner._TUNING_PATH) as f:
        assert json.load(f) == {key: kernels.tile_name(tile)}
    shapes = kernels.launch_shapes[kernels.BILATERAL]
    tuned, other = (120, 160, tile), (60, 80, tiles[0])
    before = shapes[tuned], shapes[other]
    kernels.bilateral_filter(torch.from_numpy(_depth(1, (120, 160))).to(cuda), 3.0)
    kernels.bilateral_filter(torch.from_numpy(_depth(2, (60, 80))).to(cuda), 3.0)
    assert (shapes[tuned], shapes[other]) == (before[0] + 1, before[1] + 1)
    tuner.put(key, "3x3")
    with pytest.raises(ValueError, match="'3x3'"):
        kernels.bilateral_filter(torch.from_numpy(_depth(1, (120, 160))).to(cuda), 3.0)


def _render_pair(seed, width=160, height=120):
    cam = synthetic.default_camera(width, height)
    scene = synthetic.random_plane_scene(np.random.default_rng(seed), 6)
    frames = []
    for pose in (synthetic.pose(), synthetic.pose(tx=0.015, ty=-0.01, rz=0.008)):
        depth, inten = synthetic.render_scene(cam, scene, pose)
        depth_u16 = np.clip(depth * 5000.0, 0, 65535).astype(np.int32)
        gray = np.clip(inten * 255.0 + 0.5, 0, 255).astype(np.uint8)
        frames.append((depth_u16, np.stack([gray] * 3, axis=-1)))
    return cam, frames


def _preprocess(cam, depth_u16, rgb, device):
    a = torch.zeros((), device=device)
    cfactor = torch.zeros(((cam.height - 1) // 4 + 1, (cam.width - 1) // 4 + 1), device=device)
    return preprocess_frame(cam, torch.from_numpy(depth_u16).to(device),
                            torch.from_numpy(rgb).to(device), max_depth=3.0,
                            a=a, cfactor=cfactor, raw_to_float_depth=1.0 / 5000.0)


def _compare_devices(device_a, device_b):
    """Preprocess, pyramid and track one rendered pair on both devices."""
    cam, frames = _render_pair(11)
    out = []
    for device in (device_a, device_b):
        processed = [_preprocess(cam, d, c, device) for d, c in frames]
        p0, p1 = [build_pyramid(f.depth, f.nx, f.ny, f.intensity, 4) for f in processed]
        ident = synthetic.pose()
        q = torch.as_tensor(ident.q, device=device)
        t = torch.as_tensor(ident.t, device=device)
        cams = tuple(cam.pyramid_level(i) for i in range(4))
        out.append((processed, track_frame_pairwise(cams, p0, p1, q, t, q, t)))
    (frames_a, res_a), (frames_b, res_b) = out
    for fa, fb in zip(frames_a, frames_b):
        for name in ("depth", "radius2", "intensity", "raw_depth", "nx", "ny"):
            atol = 1e-4 if name in ("nx", "ny") else 1e-5
            torch.testing.assert_close(getattr(fa, name).cpu(), getattr(fb, name).cpu(),
                                       atol=atol, rtol=0)
    torch.testing.assert_close(res_a.q.cpu(), res_b.q.cpu(), atol=1e-4, rtol=0)
    torch.testing.assert_close(res_a.t.cpu(), res_b.t.cpu(), atol=1e-4, rtol=0)
    assert int(res_a.residual_count) > 1000


@pytest.mark.cuda
def test_preprocess_and_tracking_cuda_match_cpu(cuda):
    _compare_devices(cuda, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["i32", "i64"])
def test_gather_kernel_matches_plain(cuda, dtype):
    """K2 against its plain version, exactly, with negative (wrapping) and
    out-of-range (NaN) flat indices; a CUDA tensor always launches it."""
    from badslam_torch.ops import interp

    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.standard_normal((3, 47, 61)).astype(np.float32)).to(cuda)
    px = torch.from_numpy(rng.integers(-70, 70, (3, 5000))).to(cuda, dtype)
    py = torch.from_numpy(rng.integers(-60, 60, (3, 5000))).to(cuda, dtype)
    before = kernels.launch_counts[kernels.GATHER]
    out = interp.gather_nearest(img, px, py)
    torch.cuda.synchronize()
    assert kernels.launch_counts[kernels.GATHER] == before + 1
    ref = interp.gather_nearest_plain(img, px, py)
    assert torch.isnan(ref).any()
    torch.testing.assert_close(out, ref, atol=0, rtol=0, equal_nan=True)
    with pytest.raises(ValueError):
        kernels.gather_cuda(img, px.float(), py.float())
    with pytest.raises(ValueError):
        kernels.gather_cuda(img.cpu(), px.cpu(), py.cpu())


@pytest.mark.cuda
def test_onehot_kernel_matches_plain(cuda):
    """K3 against its plain version, exactly, with rows outside the window."""
    from badslam_torch import probe_gather
    from badslam_torch.ops import interp

    img, px, py = probe_gather.make_inputs(101, 77, 7)
    py[::9, ::4] = np.clip(py[::9, ::4] + 10, 0, 100)
    img, px, py = (torch.from_numpy(a).to(cuda) for a in (img, px, py))
    before = kernels.launch_counts[kernels.GATHER_ONEHOT]
    out = interp.gather_onehot(img, px, py)
    torch.cuda.synchronize()
    assert kernels.launch_counts[kernels.GATHER_ONEHOT] == before + 1
    torch.testing.assert_close(out, interp.gather_onehot_plain(img, px, py),
                               atol=0, rtol=0)


def _bundle_adjustment(device, window=None, timings=None, **config):
    """Two rendered keyframes, the first with its surfels, the second
    starting off its true pose; one BA call of up to 8 iterations, or of
    exactly 3 in the fixed keyframe window `window` (the final BA's), with
    the BadSlamConfig fields `config` and the timing rows written to the
    stream `timings`."""
    from badslam_torch.ba.scheme import DirectBA
    from badslam_torch.config import BadSlamConfig

    cam = synthetic.default_camera(160, 120)
    scene = synthetic.random_plane_scene(np.random.default_rng(13), 3)
    truth = (synthetic.pose(), synthetic.pose(tx=0.03, ty=0.01, rz=0.01))
    start = (truth[0], synthetic.pose(tx=0.034, ty=0.007, rz=0.011))
    ba = DirectBA(cam, BadSlamConfig(max_surfel_count=1 << 14, **config),
                  surfel_capacity=1 << 14, device=device)
    ba.set_save_timings(timings)
    for i, (gt, init) in enumerate(zip(truth, start)):
        depth, inten = synthetic.render_scene(cam, scene, gt)
        depth_u16 = np.clip(depth * 5000.0, 0, 65535).astype(np.int32)
        gray = np.clip(inten * 255.0 + 0.5, 0, 255).astype(np.uint8)
        frame = _preprocess(cam, depth_u16, np.stack([gray] * 3, axis=-1), device)
        kf = ba.add_keyframe(frame, init, i)
        if i == 0:
            ba.create_surfels_for_keyframe(kf, filter_new_surfels=False)
    if window is not None:
        return ba, ba.bundle_adjustment(max_iterations=3, active_keyframe_window=window)
    return ba, ba.bundle_adjustment(max_iterations=8)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, (1, 1)], ids=["all", "window"])
def test_bundle_adjustment_cuda_matches_cpu(cuda, window, monkeypatch):
    from badslam_torch.ba import geometry_opt as geo

    plain = pose_opt.surfel_pose_coeffs_plain
    assoc = geo._assoc_batch

    def cpu_only(smap, *args):  # the card's pose pass is H2, never the plain chain
        assert not smap.pos.is_cuda
        return plain(smap, *args)

    def cpu_assoc(cam, pos, *args):  # nor is its geometry pass (H3)
        assert not pos.is_cuda
        return assoc(cam, pos, *args)
    monkeypatch.setattr(pose_opt, "surfel_pose_coeffs_plain", cpu_only)
    monkeypatch.setattr(geo, "_assoc_batch", cpu_assoc)
    before = kernels.launch_counts[kernels.GATHER]
    before_h = {name: kernels.launch_counts[name] for name in
                (kernels.POSE_COEFFS, kernels.GEOMETRY_NORMALS, kernels.GEOMETRY_POSITION)}
    on_card, iters_card = _bundle_adjustment(cuda, window)
    torch.cuda.synchronize()
    assert kernels.launch_counts[kernels.GATHER] > before
    for name, n in before_h.items():
        assert kernels.launch_counts[name] > n, name
    on_cpu, iters_cpu = _bundle_adjustment("cpu", window)
    assert iters_card == iters_cpu >= 1
    assert torch.equal(on_card.keyframes.activation[:2].cpu(), on_cpu.keyframes.activation[:2])
    for name in ("q", "t"):
        torch.testing.assert_close(getattr(on_card.keyframes, name)[:2].cpu(),
                                   getattr(on_cpu.keyframes, name)[:2], atol=1e-4, rtol=0)
    n_card, n_cpu = on_card.surfel_count, on_cpu.surfel_count
    assert n_cpu > 500 and abs(n_card - n_cpu) <= 0.01 * n_cpu


def _pose_pass(device, keyframes: int, rows: int = 131_072):
    """synthetic.pose_pass_state at 640x480, 10% of the rows live, on the
    device: (state, SurfelMap, q, t, depth, nx, ny, intensity)."""
    state = synthetic.pose_pass_state(7, keyframes, rows, 0.1, 640, 480)
    return (state, *synthetic.pose_pass_inputs(state, device))


@pytest.mark.cuda
@pytest.mark.parametrize("keyframes", [1, 8])
@pytest.mark.parametrize("use_depth,use_descriptor",
                         [(True, True), (True, False), (False, True)],
                         ids=["both", "depth", "descriptor"])
def test_pose_coeffs_kernel_matches_plain(cuda, keyframes, use_depth, use_descriptor):
    state, smap, q, t, depth, nx, ny, inten = _pose_pass(cuda, keyframes)
    args = (smap, state.cam, q, t, depth, nx, ny, inten, 40.0, use_depth, use_descriptor)
    before = kernels.launch_counts[kernels.POSE_COEFFS]
    H, b, count = pose_opt.surfel_pose_coeffs(*args)
    assert kernels.launch_counts[kernels.POSE_COEFFS] == before + 1
    H_p, b_p, count_p = pose_opt.surfel_pose_coeffs_plain(*args)
    assert torch.equal(count, count_p) and int(count.min()) > 5000
    for got, want in ((H, H_p), (b, b_p)):
        for c in range(keyframes):
            torch.testing.assert_close(got[c], want[c], rtol=1e-5,
                                       atol=1e-5 * float(want[c].abs().max()))
    assert torch.equal(H, H.transpose(-1, -2))
    # The same bits on every launch.
    for x, y in zip((H, b, count), pose_opt.surfel_pose_coeffs(*args)):
        assert torch.equal(x, y)
    # Keyframes outside the running mask: exact zeros; the others as above.
    running = (torch.arange(keyframes, device=cuda) % 3 != 1) if keyframes > 1 \
        else torch.zeros(1, dtype=torch.bool, device=cuda)
    masked = pose_opt.surfel_pose_coeffs(*args, running)
    for x, y in zip((H, b, count), masked):
        assert torch.equal(y[running], x[running])
        assert not bool(y[~running].any())
    if keyframes == 1:  # one keyframe without the batch axis
        one = pose_opt.surfel_pose_coeffs(smap, state.cam, q[0], t[0], depth[0], nx[0],
                                          ny[0], inten[0], 40.0, use_depth, use_descriptor)
        for x, y in zip((H, b, count), one):
            assert torch.equal(x[0], y)


@pytest.mark.cuda
def test_pose_coeffs_kernel_rejects_what_it_does_not_take(cuda):
    state, smap, q, t, depth, nx, ny, inten = _pose_pass(cuda, 2, rows=4096)
    R = torch.eye(3, device=cuda).expand(2, 3, 3).contiguous()
    args = [smap.pos, smap.normal, smap.radius2, smap.desc, smap.valid, R, t, depth, nx,
            ny, inten, state.cam, 40.0, True, True]
    for i, bad in ((3, smap.desc.t().contiguous().t()), (4, smap.valid.to(torch.uint8)),
                   (7, depth[:, :, :-1]), (0, smap.pos.cpu()), (6, t.double())):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError):
            kernels.pose_coeffs_cuda(*wrong)
    with pytest.raises(ValueError):
        kernels.pose_coeffs_cuda(*args, running=torch.ones(3, dtype=torch.bool, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("max_iterations", [1, 30], ids=["one_step", "loop"])
def test_optimize_keyframe_poses_kernel_matches_plain(cuda, monkeypatch, max_iterations):
    """A block of 8 slots, 6 of them set: the Gauss-Newton loops with H2
    and with the plain accumulation on the card, from one state. One step
    moves the poses alike to 1e-6. After it the association follows the
    pose: a surfel whose projection crosses a pixel edge reads another
    depth and normal, so a rounding-sized pose difference can change a
    later step by one surfel's share. Summing the plain version's rows in
    another order on the CPU moves this state's loop poses by up to
    1.2e-5 m in the same number of steps, hence 5e-5 for the loop."""
    from badslam_torch.mapping.keyframes import KeyframeStack

    state, smap, q, t, depth, nx, ny, inten = _pose_pass(cuda, 8)
    mask = torch.arange(8, device=cuda) < 6
    stack = KeyframeStack(depth, nx, ny, None, inten, q, t, mask)
    steps, out = {}, {}
    for name, fn in (("kernel", pose_opt.surfel_pose_coeffs),
                     ("plain", pose_opt.surfel_pose_coeffs_plain)):
        steps[name] = torch.zeros(8, dtype=torch.int64, device=cuda)

        def counted(*a, fn=fn, runs=steps[name], **kw):
            runs += a[-1]  # the running mask: the keyframes this step moves
            return fn(*a, **kw)
        monkeypatch.setattr(pose_opt, "surfel_pose_coeffs", counted)
        out[name] = pose_opt.optimize_keyframe_poses(smap, state.cam, stack,
                                                     max_iterations=max_iterations)
    kernel, plain = out["kernel"], out["plain"]
    assert torch.equal(steps["kernel"], steps["plain"])
    assert int(steps["kernel"][:6].min()) >= min(2, max_iterations)
    assert not bool(steps["kernel"][6:].any())
    atol = 1e-6 if max_iterations == 1 else 5e-5
    torch.testing.assert_close(kernel.q, plain.q, atol=atol, rtol=0)
    torch.testing.assert_close(kernel.t, plain.t, atol=atol, rtol=0)
    assert torch.equal(kernel.moved, plain.moved) and bool(kernel.moved[:6].all())
    assert torch.equal(kernel.q[6:], q[6:]) and torch.equal(kernel.t[6:], t[6:])


# H3's cases: the two cameras, keyframe stacks of 1, 8 and 11 slots (one
# block, a full block, a full block and a part), 131,072 rows 10% live.
GEOMETRY_CAMERAS = {"640x480": (640, 480), "739x458": (739, 458)}
GEOMETRY_NORMALS = {"activation": (True, False), "activation+normals": (True, True),
                    "normals": (False, True)}
GEOMETRY_TERMS = {"depth": (True, False), "descriptor": (False, True), "both": (True, True)}


@functools.lru_cache(maxsize=None)
def _geometry_state(camera, keyframes: int, rows: int):
    return synthetic.pose_pass_state(9, keyframes, rows, 0.1, *GEOMETRY_CAMERAS[camera])


def _geometry_pass(device, camera, keyframes: int, rows: int = 131_072):
    """synthetic.pose_pass_state at `camera` on the device with a fifth of
    the valid rows inactive and masks that leave slots out: (camera,
    SurfelMap, KeyframeStack with the operation's mask, activation mask)."""
    from badslam_torch.mapping.keyframes import KeyframeStack

    state = _geometry_state(camera, keyframes, rows)
    smap, q, t, depth, nx, ny, inten = synthetic.pose_pass_inputs(state, device)
    rng = np.random.default_rng(keyframes)
    smap = smap._replace(active=smap.valid & torch.from_numpy(
        rng.uniform(size=rows) < 0.8).to(device))
    slot = torch.arange(keyframes, device=device)
    mask = (slot % 4 != 2) | (slot == 0)
    strict = mask & ((slot % 3 != 1) | (slot == 0))
    # No pass of the geometry step reads the keyframes' radii.
    stack = KeyframeStack(depth, nx, ny, torch.zeros_like(depth), inten, q, t, mask)
    return state.cam, smap, stack, strict


@pytest.mark.cuda
@pytest.mark.parametrize("keyframes", [1, 8, 11])
@pytest.mark.parametrize("camera", list(GEOMETRY_CAMERAS))
@pytest.mark.parametrize("kind", list(GEOMETRY_NORMALS))
def test_geometry_normals_kernel_matches_plain(cuda, kind, camera, keyframes):
    """H3's activation and normals against the plain chain on the card, bit
    for bit: each block's carry (activation flags, normal sums, counts),
    then the finished map (activation, normals); the same bits on a
    repeated launch."""
    from badslam_torch.ba import geometry_opt as geo
    from badslam_torch.mapping.keyframes import static_blocks

    cam, smap, stack, strict = _geometry_pass(cuda, camera, keyframes)
    activation, normals = GEOMETRY_NORMALS[kind]
    before = kernels.launch_counts[kernels.GEOMETRY_NORMALS]
    carries = {}
    for name, chunk in (("kernel", (geo._act_normals_chunk, geo._normals_chunk)),
                        ("plain", (geo._act_normals_chunk_plain, geo._normals_chunk_plain))):
        act, nsum, cnt = geo._act_normals_init(smap)
        for s in static_blocks(keyframes):
            if activation:
                act, nsum, cnt = chunk[0]((act, nsum, cnt), stack.rows(s), strict[s],
                                          stack.mask[s], smap, cam, 40.0, normals)
            else:
                nsum, cnt = chunk[1]((nsum, cnt), stack.rows(s), smap, cam, 40.0)
            carries[name] = (act.clone(), nsum.clone(), cnt.clone())
    blocks = len(static_blocks(keyframes))
    assert kernels.launch_counts[kernels.GEOMETRY_NORMALS] == before + blocks
    (k_act, k_sum, k_cnt), (p_act, p_sum, p_cnt) = carries["kernel"], carries["plain"]
    assert torch.equal(k_act, p_act & smap.valid) and torch.equal(k_cnt, p_cnt)
    assert torch.equal(k_sum, p_sum)
    assert int(p_cnt.sum()) > 1000 or not normals
    assert int(p_act.sum()) > 1000 or not activation

    if activation:
        args = (smap, cam, stack, strict, stack.mask, 40.0, normals)
        got = geo.update_activation_and_normals(*args)
        want = geo.update_activation_and_normals_plain(*args)
        again = geo.update_activation_and_normals(*args)
    else:
        args = (smap, cam, stack, 40.0)
        got = geo.update_surfel_normals(*args)
        want = geo.update_surfel_normals_plain(*args)
        again = geo.update_surfel_normals(*args)
    assert torch.equal(got.active, want.active) and torch.equal(got.normal, want.normal)
    assert normals == bool((want.normal != smap.normal).any())
    assert torch.equal(got.normal, again.normal) and torch.equal(got.active, again.active)


@pytest.mark.cuda
@pytest.mark.parametrize("keyframes", [1, 8, 11])
@pytest.mark.parametrize("camera", list(GEOMETRY_CAMERAS))
@pytest.mark.parametrize("terms", list(GEOMETRY_TERMS))
def test_geometry_position_kernel_matches_plain(cuda, terms, camera, keyframes):
    """H3's position and descriptor step against the plain chain on the
    card, bit for bit: each row's summed system after every block, then the
    positions and descriptors; the same bits on a repeated launch."""
    from badslam_torch.ba import geometry_opt as geo
    from badslam_torch.mapping.keyframes import static_blocks

    cam, smap, stack, _ = _geometry_pass(cuda, camera, keyframes)
    use_depth, use_descriptor = GEOMETRY_TERMS[terms]
    before = kernels.launch_counts[kernels.GEOMETRY_POSITION]
    sums = geo._pos_init(smap, use_descriptor)
    plain = geo._pos_init_plain(smap, use_descriptor)
    for s in static_blocks(keyframes):
        sums = geo._pos_chunk(sums, stack.rows(s), smap, cam, 40.0, use_depth, use_descriptor)
        plain = geo._pos_chunk_plain(plain, stack.rows(s), smap, cam, 40.0, use_depth,
                                     use_descriptor)
        kept = plain
        if use_descriptor:
            assert not bool(plain[4].any())  # H12, which the kernel does not keep
            kept = plain[:4] + plain[5:]
        assert torch.equal(sums, torch.stack(kept))
    assert kernels.launch_counts[kernels.GEOMETRY_POSITION] == \
        before + len(static_blocks(keyframes))

    args = (smap, cam, stack, 40.0, use_depth, use_descriptor)
    got = geo._position_step(*args)
    want = geo._position_step_plain(*args)
    assert int((want.pos != smap.pos).any(dim=1).sum()) > 1000
    assert torch.equal(got.pos, want.pos) and torch.equal(got.desc, want.desc)
    again = geo._position_step(*args)
    assert torch.equal(got.pos, again.pos) and torch.equal(got.desc, again.desc)


@pytest.mark.cuda
def test_geometry_kernels_reject_what_they_do_not_take(cuda):
    from badslam_torch.ba import geometry_opt as geo

    cam, smap, stack, strict = _geometry_pass(cuda, "640x480", 8, rows=4096)
    act, nsum, cnt = geo._act_normals_init(smap)
    head = [smap.pos, smap.normal, smap.valid, smap.active, stack.q, stack.t, stack.depth,
            stack.nx, stack.ny, cam, 40.0, (act, nsum, cnt)]
    kernels.geometry_normals_cuda(*head, act_mask=strict, normal_mask=stack.mask)
    for i, bad in ((0, smap.pos.cpu()), (1, smap.normal.t().contiguous().t()),
                   (2, smap.valid.to(torch.uint8)), (4, stack.q.double()),
                   (6, stack.depth[:, :, :-1]), (11, (act, nsum, cnt.int())),
                   (11, (None, None, None))):
        wrong = list(head)
        wrong[i] = bad
        with pytest.raises(ValueError):
            kernels.geometry_normals_cuda(*wrong, act_mask=strict)
    with pytest.raises(ValueError):  # more slots than a launch takes
        big = [x.repeat(2, *([1] * (x.ndim - 1))) for x in head[4:9]]
        kernels.geometry_normals_cuda(*head[:4], *big, *head[9:], act_mask=strict.repeat(2))
    with pytest.raises(ValueError):  # activation without its carry
        kernels.geometry_normals_cuda(*head[:11], (None, nsum, cnt), act_mask=strict)
    with pytest.raises(ValueError):
        kernels.geometry_normals_cuda(*head, act_mask=strict[:-1])
    sums = geo._pos_init(smap, True)
    pos_head = [smap.pos, smap.normal, smap.radius2, smap.desc, smap.valid, smap.active,
                stack.q, stack.t, stack.depth, stack.nx, stack.ny, stack.intensity,
                stack.mask, cam, 40.0, True, True, sums]
    kernels.geometry_position_cuda(*pos_head)
    for i, bad in ((3, smap.desc[:, :1].contiguous()), (5, smap.active.cpu()),
                   (11, None), (12, stack.mask[:-1]), (17, geo._pos_init(smap, False))):
        wrong = list(pos_head)
        wrong[i] = bad
        with pytest.raises(ValueError):
            kernels.geometry_position_cuda(*wrong)
    with pytest.raises(ValueError):
        kernels.geometry_position_finish_cuda(smap.pos, smap.normal, smap.desc, smap.valid,
                                              smap.active, sums[:2].contiguous(), True)
    with pytest.raises(ValueError):
        kernels.geometry_normals_finish_cuda(smap.normal, smap.valid, smap.active,
                                             (None, nsum.double(), cnt))


@pytest.mark.cuda
def test_geometry_sharded_on_one_card_matches_one_device(cuda):
    """parallel/sharded.py's geometry step over 2 shards of the card (its
    chunk bodies, the planes streamed from their owners) against the one
    device's: each row's arithmetic is its own, so bit for bit."""
    from badslam_torch import parallel
    from badslam_torch.ba import geometry_opt as geo

    cam, smap, stack, _ = _geometry_pass(cuda, "640x480", 11, rows=65_536)
    before = kernels.launch_counts[kernels.GEOMETRY_POSITION]
    mesh = parallel.make_mesh(devices=[cuda, cuda])
    got = parallel.optimize_geometry_sharded(mesh, smap, cam, stack)
    want = geo.optimize_geometry_iteration(smap, cam, stack)
    # Two blocks and a finish per shard, then the same on one device.
    assert kernels.launch_counts[kernels.GEOMETRY_POSITION] == before + 2 * 3 + 3
    assert int((want.pos != smap.pos).any(dim=1).sum()) > 1000
    for name in ("pos", "normal", "desc", "valid", "active"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


# H1's cameras: 640x480 and the ETH3D SLAM camera's 739x458, each at its
# finest level and its coarsest of five (40x30, 46x28); its residual sets
# (use_depth, use_descriptor, use_gradmag).
TRACK_CAMERAS = {
    "640x480": synthetic.default_camera(640, 480),
    "739x458": PinholeCamera(fx=726.3, fy=726.3, cx=355.1, cy=187.0, width=739, height=458),
}
TRACK_LEVELS = [pytest.param("640x480", 0, id="640x480"), pytest.param("640x480", 4, id="40x30"),
                pytest.param("739x458", 0, id="739x458"), pytest.param("739x458", 4, id="46x28")]
TRACK_RESIDUALS = {"depth+descriptor": (True, True, False), "depth": (True, False, False),
                   "descriptor": (False, True, False), "gradmag": (True, False, True)}


def _track_case(device, camera, level, residuals):
    """The rendered pair's level on `device` with an estimate off the true
    motion, as a Gauss-Newton step starts from: the arguments of
    pairwise.accumulate_pose_coeffs."""
    use_depth, use_descriptor, use_gradmag = TRACK_RESIDUALS[residuals]
    cams, base, tracked, (q, t) = synthetic.tracking_pair(
        TRACK_CAMERAS[camera], 3, device, gradmag=use_gradmag)
    q = q + torch.tensor([0.0, 0.001, -0.0015, 0.0005], device=device)
    q = q / torch.linalg.vector_norm(q)
    t = t + torch.tensor([0.004, 0.003, -0.005], device=device)
    return (cams[level], base[level], tracked[level], q, t, float(2 ** level), 40.0,
            use_depth, use_descriptor, use_gradmag)


@pytest.mark.cuda
@pytest.mark.parametrize("residuals", list(TRACK_RESIDUALS))
@pytest.mark.parametrize("camera, level", TRACK_LEVELS)
def test_track_coeffs_kernel_matches_plain(cuda, camera, level, residuals):
    """H1's coefficient and cost modes against the plain chain on the card:
    counts exact, H and b within 1e-5 of each one's largest entry, the cost
    within 1e-5 relative (float32 both; the per-pixel terms are the same
    operations, the sums run in another order), the same bits on every
    launch, one launch counted per call."""
    args = _track_case(cuda, camera, level, residuals)
    before = kernels.launch_counts[kernels.TRACK_COEFFS]
    H, b, count = pairwise.accumulate_pose_coeffs(*args)
    cost, n = pairwise.compute_cost_and_count(*args)
    assert kernels.launch_counts[kernels.TRACK_COEFFS] == before + 2
    H_p, b_p, count_p = pairwise.accumulate_pose_coeffs_plain(*args)
    cost_p, n_p = pairwise.compute_cost_and_count_plain(*args)
    assert torch.equal(count, count_p) and int(count) > (200 if level else 20_000)
    assert torch.equal(n, n_p) and int(n) > 0
    for got, want in ((H, H_p), (b, b_p)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(H, H.T)
    assert abs(float(cost) - float(cost_p)) <= 1e-5 * abs(float(cost_p))
    for x, y in zip((H, b, count, cost, n), (*pairwise.accumulate_pose_coeffs(*args),
                                             *pairwise.compute_cost_and_count(*args))):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("residuals", ["depth+descriptor", "gradmag"])
@pytest.mark.parametrize("camera, level", TRACK_LEVELS)
def test_track_step_kernel_matches_plain(cuda, camera, level, residuals):
    """One whole Gauss-Newton step with H1 (both kernels) against the plain
    _gn_step: q and t within 1e-6, the same convergence flag; the step in
    place with the WHILE body's loop state gives the same bits, one
    iteration and the condition."""
    cam, base, tracked, q, t, s, bfx, use_depth, use_desc, use_gradmag = _track_case(
        cuda, camera, level, residuals)
    step = (cam, base, tracked, q, t, s, 0.5, bfx, use_depth, use_desc, use_gradmag)
    q_k, t_k, done_k = pairwise._gn_step(*step)
    q_p, t_p, done_p = pairwise._gn_step_plain(*step)
    torch.testing.assert_close(q_k, q_p, atol=1e-6, rtol=0)
    torch.testing.assert_close(t_k, t_p, atol=1e-6, rtol=0)
    assert bool(done_k) == bool(done_p)
    assert float((t_k - t).abs().max()) > 1e-4  # the step moved the pose
    q_i, t_i = q.clone(), t.clone()
    done = torch.zeros((), dtype=torch.bool, device=cuda)
    i = torch.zeros((), dtype=torch.int64, device=cuda)
    flag = torch.ones((), dtype=torch.bool, device=cuda)
    kernels.track_step_cuda(cam, base, tracked, q_i, t_i, s, 0.5, pairwise._converge_below(s),
                            bfx, use_depth, use_desc, use_gradmag, q_i, t_i, done,
                            iterations=i, flag=flag, bound=2)
    assert torch.equal(q_i, q_k) and torch.equal(t_i, t_k) and torch.equal(done, done_k)
    assert int(i) == 1 and bool(flag) == (not bool(done_k))


@pytest.mark.cuda
@pytest.mark.parametrize("camera, level", TRACK_LEVELS)
def test_track_duel_kernel_picks_as_plain(cuda, camera, level):
    """The duel over two poses in one H1 launch picks the pose the plain
    _duel picks, for pairs that differ by a little, by much, and in count."""
    cam, base, tracked, q, t, s, bfx, *flags = _track_case(
        cuda, camera, level, "depth+descriptor")
    true_q, true_t = synthetic.tracking_pair(TRACK_CAMERAS[camera], 3, cuda)[3]
    near = (q, t)
    truth = (true_q, true_t)
    far = (true_q, true_t + torch.tensor([0.2, -0.1, 0.05], device=cuda))
    for a, b in ((truth, near), (near, truth), (truth, far), (far, near), (near, near)):
        before = kernels.launch_counts[kernels.TRACK_COEFFS]
        got = pairwise._duel(cam, base, tracked, *a, *b, s, bfx, *flags)
        assert kernels.launch_counts[kernels.TRACK_COEFFS] == before + 1
        want = pairwise._duel_plain(cam, base, tracked, *a, *b, s, bfx, *flags)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_track_loop_kernel_matches_plain(cuda, monkeypatch):
    """The coarse-to-fine tracker at 640x480 (five scales, duels, the host
    loop) with H1 and with the plain chains on the card: the same
    Gauss-Newton iterations per scale and poses within 1e-5."""
    cams, base, tracked, (q, t) = synthetic.tracking_pair(TRACK_CAMERAS["640x480"], 3, cuda)
    start = (q, t + torch.tensor([0.01, -0.01, 0.005], device=cuda))
    runs = {}
    for name in ("kernel", "plain"):
        if name == "plain":
            monkeypatch.setattr(pairwise, "_gn_step", pairwise._gn_step_plain)
            monkeypatch.setattr(pairwise, "_duel", pairwise._duel_plain)
            monkeypatch.setattr(pairwise, "compute_cost_and_count",
                                pairwise.compute_cost_and_count_plain)
        runs[name] = pairwise.track_frame_pairwise(cams, base, tracked, *start, *start)
    k, p = runs["kernel"], runs["plain"]
    assert k.iterations == p.iterations and sum(k.iterations) > 5
    torch.testing.assert_close(k.q, p.q, atol=1e-5, rtol=0)
    torch.testing.assert_close(k.t, p.t, atol=1e-5, rtol=0)
    assert int(k.residual_count) == int(p.residual_count)
    assert float((k.t - t).abs().max()) < 1e-3  # it tracked


@pytest.mark.cuda
def test_track_kernel_rejects_what_it_does_not_take(cuda):
    cam, base, tracked, q, t, s, bfx, *flags = _track_case(cuda, "640x480", 4, "depth")
    wrong_inputs = [
        (base._replace(nx=base.nx.t().contiguous().t()), tracked, q, t),  # not contiguous
        (base, tracked._replace(depth=tracked.depth.cpu()), q, t),        # another device
        (base, tracked._replace(intensity=tracked.intensity[:, :-1].contiguous()), q, t),
        (base, tracked, q.double(), t),
        (base, tracked, q, t[:2]),
    ]
    for b_, tr, q_, t_ in wrong_inputs:
        with pytest.raises(ValueError):
            kernels.track_coeffs_cuda(cam, b_, tr, q_, t_, s, bfx, *flags)
    with pytest.raises(ValueError):
        kernels.track_step_cuda(cam, base, tracked, q, t, s, 1.0, 1e-8, bfx, *flags, q, t,
                                torch.zeros((), dtype=torch.int64, device=cuda))


@pytest.mark.cuda
def test_undistortion_and_median_cuda_match_cpu(cuda):
    """The distorted input path on the card: depth (nearest) and color
    (bilinear) undistortion through K2, then the median filter, against
    the CPU: exact for the nearest taps and the median, 1e-5 for the
    bilinear color (its hold against JAX)."""
    from badslam_torch.geometry.camera import RadTanCamera, decide_undistorted_camera
    from badslam_torch.ops.preprocess import median_filter_and_densify, undistort_image

    src = RadTanCamera(pinhole=synthetic.default_camera(160, 120), k1=-0.06, k2=0.01)
    cam = decide_undistorted_camera(src)
    depth, inten = synthetic.render_scene_radtan(src, synthetic.random_plane_scene(
        np.random.default_rng(2), 5), synthetic.pose(tx=0.01))
    depth[np.random.default_rng(2).uniform(size=depth.shape) < 0.1] = 0.0
    rgb = np.stack([np.clip(inten * 255.0, 0, 255)] * 3, axis=-1).astype(np.float32)
    umap = torch.from_numpy(src.undistortion_map(cam))
    out = {}
    for device in (cuda, torch.device("cpu")):
        before = kernels.launch_counts[kernels.GATHER]
        d = undistort_image(torch.from_numpy(depth).to(device), umap.to(device), nearest=True)
        c = undistort_image(torch.from_numpy(rgb).to(device), umap.to(device))
        out[device.type] = (d.cpu(), median_filter_and_densify(d).cpu(), c.cpu())
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.launch_counts[kernels.GATHER] == before + 5
    (dg, mg, cg), (dc, mc, cc) = out["cuda"], out["cpu"]
    assert dg.shape == (cam.height, cam.width) and cg.shape == (cam.height, cam.width, 3)
    torch.testing.assert_close(dg, dc, atol=0, rtol=0)
    torch.testing.assert_close(mg, mc, atol=0, rtol=0)
    torch.testing.assert_close(cg, cc, atol=1e-5, rtol=0)


def _calibration_ba(device):
    """Four rendered keyframes with their surfels, the camera perturbed
    (fx x 1.004, cx + 0.5 px, cy - 0.5 px) and the second keyframe off its
    true pose. The frames are preprocessed on the CPU for either device,
    so that both start from the same keyframes."""
    from badslam_torch.ba.scheme import DirectBA
    from badslam_torch.config import BadSlamConfig

    cam = synthetic.default_camera(128, 96)
    scene = synthetic.random_plane_scene(np.random.default_rng(17), 4)
    ba = DirectBA(cam, BadSlamConfig(max_surfel_count=1 << 14),
                  surfel_capacity=1 << 14, device=device)
    for i in range(4):
        gt = synthetic.pose(tx=0.05 * i, ry=0.01 * i, ty=0.02 * (i % 2))
        depth, inten = synthetic.render_scene(cam, scene, gt)
        depth_u16 = np.clip(depth * 5000.0, 0, 65535).astype(np.int32)
        gray = np.clip(inten * 255.0 + 0.5, 0, 255).astype(np.uint8)
        frame = _preprocess(cam, depth_u16, np.stack([gray] * 3, axis=-1), "cpu")
        frame = type(frame)(*(None if x is None else x.to(device) for x in frame))
        init = synthetic.pose(tx=0.054, ry=0.01, ty=0.018) if i == 1 else gt
        kf = ba.add_keyframe(frame, init, i)
        ba.create_surfels_for_keyframe(kf, filter_new_surfels=i > 0)
    ba.cam = cam.with_intrinsics(fx=cam.fx * 1.004, fy=cam.fy, cx=cam.cx + 0.5,
                                 cy=cam.cy - 0.5)
    return ba


def _cam_list(cam):
    return [cam.fx, cam.fy, cam.cx, cam.cy]


@pytest.mark.cuda
def test_intrinsics_step_cuda_matches_cpu(cuda):
    """One self-calibration step (depth and color) on the card against the
    CPU: the camera 4e-5 relative and cfactor atol 3e-5, the joint-step
    holds of tests/test_torch_intrinsics.py (the float order of the sums,
    index_add_'s atomics on the card among them, amplified by the reduced
    system's conditioning), the K2 gathers launched."""
    out = {}
    for device in (cuda, torch.device("cpu")):
        ba = _calibration_ba(device)
        before = kernels.launch_counts[kernels.GATHER]
        ba.optimize_intrinsics_step(True, True)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.launch_counts[kernels.GATHER] > before
        out[device.type] = ba
    card, cpu = out["cuda"], out["cpu"]
    assert _cam_list(card.cam) != _cam_list(_calibration_ba("cpu").cam)
    np.testing.assert_allclose(_cam_list(card.cam), _cam_list(cpu.cam), rtol=4e-5, atol=0)
    torch.testing.assert_close(card.depth_params.cfactor.cpu(), cpu.depth_params.cfactor,
                               atol=3e-5, rtol=0)
    k = cpu.keyframes.count
    torch.testing.assert_close(card.keyframes.depth[:k].cpu(), cpu.keyframes.depth[:k],
                               atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_pcg_step_cuda_matches_cpu(cuda):
    """One PCG outer iteration with self-calibration on the card against the
    CPU, from the same state: poses and surfel positions atol 1e-5, the
    camera 1e-5 relative (tests/test_torch_pcg.py's one-step holds against
    JAX), the CG steps equal, the K2 gathers launched."""
    from badslam_torch.ba.pcg import pcg_bundle_adjustment_step

    out = {}
    for device in (cuda, torch.device("cpu")):
        ba = _calibration_ba(device)
        ks = ba.keyframes
        before = kernels.launch_counts[kernels.GATHER]
        res = pcg_bundle_adjustment_step(
            ba.surfels._replace(active=ba.surfels.valid), ba.cam, ks.stack(),
            raw_depth=ks.stack_raw(), params=ba.depth_params, max_inner_iterations=10,
            optimize_intrinsics=True)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert kernels.launch_counts[kernels.GATHER] > before
        out[device.type] = res
    card, cpu = out["cuda"], out["cpu"]
    assert card.cg_steps == cpu.cg_steps > 0
    for name in ("q", "t"):
        torch.testing.assert_close(getattr(card, name).cpu(), getattr(cpu, name),
                                   atol=1e-5, rtol=0)
    v = cpu.smap.valid
    torch.testing.assert_close(card.smap.pos.cpu()[v], cpu.smap.pos[v], atol=1e-5, rtol=0)
    np.testing.assert_allclose(_cam_list(card.cam), _cam_list(cpu.cam), rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_loop_closure_cuda_matches_cpu(cuda):
    """The closure's gates, pose graph and trajectory deformation on the
    card against the CPU: 16 drifted keyframes of a loop (every 10th of 160
    frames) closed from keyframe 15 onto keyframe 0; poses and trajectory
    atol 1e-5 (float32 dense solves in another order), the same gate
    decisions."""
    from badslam_torch.geometry import se3_np as s3
    from badslam_torch.loop.closure import apply_closure

    gt = synthetic.loop_trajectory(160, loop_frames=150, orbit_radius=0.4)
    kfs = [s3.SE3(np.asarray(gt[i].q, float), np.asarray(gt[i].t, float)) for i in range(0, 160, 10)]
    poses, drift = [], s3.identity()
    for p in kfs:
        poses.append(s3.mul(drift, p))
        drift = s3.mul(s3.exp(np.array([0.001, 0, 0.0005, 0, 0.0017, 0])), drift)
    truth = s3.mul(s3.inverse(kfs[15]), kfs[0])
    refs = [s3.mul(truth, s3.exp(np.array(d, float))) for d in
            ([0] * 6, [0.004, 0, 0, 0, 0.002, 0], [0, -0.003, 0, 0, 0, 0.002])]
    q = np.stack([p.q for p in poses]).astype(np.float32)
    t = np.stack([p.t for p in poses]).astype(np.float32)
    traj_q = np.repeat(q, 10, axis=0)
    traj_t = np.repeat(t, 10, axis=0)
    kf_frames = np.arange(16) * 10
    fi = np.arange(160)
    j = np.searchsorted(kf_frames, fi, side="right")
    prev, nxt = np.clip(j - 1, 0, 15), np.clip(j, 0, 15)
    inner = j < 16
    alpha = np.where(inner, (fi - kf_frames[prev]) / 10.0, 0.0).astype(np.float32)
    nxt = np.where(inner, nxt, 15)
    kf_slot = np.full(160, -1)
    kf_slot[kf_frames] = np.arange(16)
    pts = np.random.default_rng(2).uniform([-1, -0.7, 1], [1, 0.7, 3], (60, 3)).astype(np.float32)
    cam = synthetic.default_camera(128, 96)
    out = []
    for device in (cuda, torch.device("cpu")):
        def dev(x, dtype=None):
            return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

        # Written in place: the store's poses, the trajectory, the counter.
        state = [dev(x).clone() for x in (q, t, traj_q, traj_t)]
        count = torch.zeros((), dtype=torch.int64, device=device)
        res = apply_closure(
            state[0], state[1], dev(np.arange(16)), 16, 15, 0,
            dev(np.stack([r.q for r in refs]), torch.float32),
            dev(np.stack([r.t for r in refs]), torch.float32),
            dev(np.ones(3, bool)), dev(pts), dev(np.ones(60, bool)), state[2], state[3],
            dev(prev), dev(nxt), dev(alpha), dev(kf_slot), count, cam)
        out.append((bool(res.ok), int(count), state))
    (card_ok, card_n, card), (cpu_ok, cpu_n, cpu) = out
    assert card_ok and cpu_ok and card_n == cpu_n == 1
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)
    assert float((card[1].cpu() - torch.from_numpy(t)).abs().max()) > 1e-2


def _live_run(device, path, viewer_dir=None):
    """run_live over a finished directory stream (tests/test_torch_live.py's
    96x72 frames and configuration) on one device."""
    from badslam_torch.config import BadSlamConfig
    from badslam_torch.frontend import BadSlam
    from badslam_torch.io.live_inputs import open_live_input
    from badslam_torch.viz.viewer import LiveViewer

    inp = open_live_input(f"dir:{path}")
    try:
        video = inp.start(max_frames=32)
        slam = BadSlam(BadSlamConfig(num_scales=3, keyframe_interval=4,
                                     max_num_ba_iterations_per_keyframe=2,
                                     max_surfel_count=1 << 12, tracking_max_iterations=8,
                                     enable_loop_detection=False), video, device)
        if viewer_dir is not None:
            slam.live_viewer = LiveViewer(viewer_dir, port=None, interval=1)
        processed = slam.run_live()
    finally:
        inp.stop()
    return slam, processed


@pytest.mark.cuda
def test_run_live_cuda_matches_cpu(cuda, tmp_path):
    """A live directory stream on the card against the CPU: poses atol 1e-4,
    surfel counts within 1%, K1 once per frame and K2 launched on the card;
    the live viewer's snapshots (device reads) on the card."""
    import json
    import os

    from badslam_torch.io.png import write_png

    cam = synthetic.default_camera(96, 72)
    scene = synthetic.random_plane_scene(np.random.default_rng(0), 3)
    path = str(tmp_path / "stream")
    os.makedirs(os.path.join(path, "depth"))
    os.makedirs(os.path.join(path, "rgb"))
    with open(os.path.join(path, "calibration.txt"), "w") as f:
        f.write(f"{cam.fx} {cam.fy} {cam.cx} {cam.cy}\n")
    for i, pose in enumerate(synthetic.smooth_trajectory(8, scale=0.003)):
        depth, inten = synthetic.render_scene(cam, scene, pose)
        g = np.clip(inten * 255 + 0.5, 0, 255).astype(np.uint8)
        write_png(os.path.join(path, "depth", f"{i:03d}.png"),
                  np.clip(depth * 5000.0, 0, 65535).astype(np.uint16))
        write_png(os.path.join(path, "rgb", f"{i:03d}.png"), np.stack([g, g, g], -1))
    open(os.path.join(path, "end"), "w").close()

    kernels.reset_launch_counts()
    card, n_card = _live_run(cuda, path, str(tmp_path / "view"))
    torch.cuda.synchronize()
    assert kernels.launch_counts[kernels.BILATERAL] == 8
    assert kernels.launch_counts[kernels.GATHER] > 0
    cpu, n_cpu = _live_run("cpu", path)
    assert n_card == n_cpu == 8
    torch.testing.assert_close(card.traj_q[:8].cpu(), cpu.traj_q[:8], atol=1e-4, rtol=0)
    torch.testing.assert_close(card.traj_t[:8].cpu(), cpu.traj_t[:8], atol=1e-4, rtol=0)
    assert abs(card.direct_ba.surfel_count - cpu.direct_ba.surfel_count) <= 0.01 * cpu.direct_ba.surfel_count
    with open(tmp_path / "view" / "map_data.json") as f:
        assert json.load(f)["generation"] == 2  # one snapshot per keyframe


def _mesh_scene(device, mesh=None, **cfg):
    """Four rendered 128x96 keyframes, each a few mm off its truth, and
    the surfels of the first (all active); the frames are preprocessed and
    the surfels created on the CPU, then copied to `device`, so that both
    devices start from the same state."""
    from badslam_torch.ba.scheme import DirectBA
    from badslam_torch.config import BadSlamConfig

    cam = synthetic.default_camera(128, 96)
    scene = synthetic.random_plane_scene(np.random.default_rng(41), 3)
    truth = [synthetic.pose(), synthetic.pose(tx=0.03, rz=0.01),
             synthetic.pose(tx=0.05, ty=0.02), synthetic.pose(ty=-0.03)]
    bas = [DirectBA(cam, BadSlamConfig(max_surfel_count=1 << 13, **cfg),
                    surfel_capacity=1 << 13, device=dev, mesh=m)
           for dev, m in (("cpu", None), (device, mesh))]
    for i, gt in enumerate(truth):
        depth, inten = synthetic.render_scene(cam, scene, gt)
        depth_u16 = np.clip(depth * 5000.0, 0, 65535).astype(np.int32)
        gray = np.clip(inten * 255.0 + 0.5, 0, 255).astype(np.uint8)
        frame = _preprocess(cam, depth_u16, np.stack([gray] * 3, axis=-1), "cpu")
        init = gt if i == 0 else synthetic.pose(tx=float(gt.t[0]) + 0.003,
                                                ty=float(gt.t[1]) - 0.002, rz=0.001)
        for ba in bas:
            ba.add_keyframe(frame._replace(**{k: v.to(ba.device) for k, v in
                                              frame._asdict().items() if v is not None}),
                            init, i)
    bas[0].create_surfels_for_keyframe(0, filter_new_surfels=False)
    smap = bas[0].surfels._replace(active=bas[0].surfels.valid)
    ba = bas[1]
    ba.surfels = smap._replace(**{f: getattr(smap, f).to(ba.device) for f in smap._fields})
    return cam, ba


def _parallel_stages(mesh, device):
    """The ten functions of parallel/sharded.py and streamed.py on one
    scene over `mesh` (planes streamed), each result on the CPU."""
    from badslam_torch import parallel as par

    cam, ba = _mesh_scene(device)
    ks = ba.keyframes
    k = ks.count
    smap = ba.surfels
    stack = ks.stack()
    planes = par.Planes.of_store(mesh, ks, streamed=True)
    out = {}
    r = par.optimize_keyframe_poses_sharded(mesh, smap, cam, stack)
    out["poses_sharded"] = (r.q, r.t)
    out["geometry_sharded"] = par.optimize_geometry_sharded(mesh, smap, cam, stack)
    out["geometry_streamed"] = par.optimize_geometry_plane_streamed(mesh, smap, cam, stack)
    out["pose_gn"] = par.estimate_pose_sharded(mesh, smap, cam, ks.q[1], ks.t[1], ks.depth[1],
                                               ks.nx[1], ks.ny[1], ks.intensity[1])
    sm = par.shard_rows(mesh, smap)
    sm, _ = par.create_surfels_streamed(mesh, sm, cam, planes, ks.q[:k], ks.t[:k],
                                        ks.mask_for_ids([1, 2]), ks.covis, ks.valid, 2,
                                        baseline_fx=40.0, cell_size=4)
    out["create"] = par.gather_rows(mesh, sm)
    part = ks.valid[:k]
    sm = par.activation_geometry_streamed(
        mesh, sm, cam, planes, ks.q[:k], ks.t[:k], part, part, baseline_fx=40.0,
        use_depth=True, use_descriptor=True, optimize_geometry=True)
    out["activation_geometry"] = par.gather_rows(mesh, sm)
    sm = par.merge_surfels_streamed(mesh, sm, cam, planes, ks.q[:k], ks.t[:k],
                                    ks.mask_for_ids([0, 1, 2]), baseline_fx=40.0, cell_size=4)
    out["merge"] = par.gather_rows(mesh, sm)
    sm = par.delete_surfels_streamed(mesh, sm, cam, planes, ks.q[:k], ks.t[:k], part, 2,
                                     baseline_fx=40.0)
    out["delete"] = par.gather_rows(mesh, sm)
    sm = par.compact_surfels_streamed(mesh, sm)
    out["compact"] = par.gather_rows(mesh, sm)
    r = par.optimize_poses_streamed(mesh, sm, cam, planes, ks.q[:k], ks.t[:k], part,
                                    baseline_fx=40.0, use_depth=True, use_descriptor=True)
    out["poses_streamed"] = (r.q, r.t)
    return {name: v._replace(**{f: getattr(v, f).cpu() for f in v._fields})
            if hasattr(v, "_fields") else tuple(x.cpu() for x in v)
            for name, v in out.items()}


def _assert_stage_maps_close(a, b, what):
    assert abs(int(a.count) - int(b.count)) <= 0.01 * int(b.count), what
    both = a.valid & b.valid
    assert int(both.sum()) >= 0.99 * int(b.valid.sum()), what
    for name, tol in (("pos", 1e-4), ("normal", 1e-4), ("desc", 2e-3)):
        torch.testing.assert_close(getattr(a, name)[both], getattr(b, name)[both],
                                   atol=tol, rtol=0, msg=lambda m: f"{what}: {name}: {m}")


@pytest.mark.cuda
def test_parallel_stages_cuda_match_cpu(cuda):
    from badslam_torch.parallel import make_mesh

    kernels.reset_launch_counts()
    card = _parallel_stages(make_mesh(devices=[cuda, cuda]), cuda)
    torch.cuda.synchronize()
    tags = kernels.launch_tags[kernels.GATHER]
    assert tags[0] > 0 and tags[1] > 0, dict(tags)  # K2 on both shards
    cpu = _parallel_stages(make_mesh(2, "cpu"), "cpu")
    for name, value in card.items():
        if hasattr(value, "_fields"):
            _assert_stage_maps_close(value, cpu[name], name)
        else:
            for x, y in zip(value, cpu[name]):
                torch.testing.assert_close(x, y, atol=1e-4, rtol=0,
                                           msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [2048.0, 0.0], ids=["integrated", "streamed"])
def test_mesh_bundle_adjustment_cuda_matches_cpu(cuda, budget):
    """DirectBA with n_devices=2: 2 shards on the card (an explicit mesh)
    against 2 on the CPU and against one card without a mesh."""
    from badslam_torch.parallel import make_mesh

    runs = {}
    for tag, device, mesh in (("card", cuda, make_mesh(devices=[cuda, cuda])),
                              ("cpu", "cpu", None), ("one", cuda, None)):
        n = 0 if tag == "one" else 2
        _, ba = _mesh_scene(device, mesh, n_devices=n, plane_replication_budget_mb=budget)
        iterations = ba.bundle_adjustment(max_iterations=4)
        runs[tag] = (ba, iterations)
    card, iters = runs["card"]
    assert card._streaming == (budget == 0.0)
    for tag in ("cpu", "one"):
        other, other_iters = runs[tag]
        assert iters == other_iters >= 1
        for name in ("q", "t"):
            torch.testing.assert_close(getattr(card.keyframes, name)[:4].cpu(),
                                       getattr(other.keyframes, name)[:4].cpu(),
                                       atol=1e-4, rtol=0)
        assert abs(card.surfel_count - other.surfel_count) <= 0.01 * other.surfel_count


@pytest.mark.cuda
def test_staged_timing_rows_cuda_match_cpu(cuda):
    import io

    rows = {}
    for device in (cuda, "cpu"):
        stream = io.StringIO()
        _bundle_adjustment(device, timings=stream, sync_stage_profiling=True)
        rows[str(device)] = stream.getvalue().splitlines()
    card, cpu = rows[str(cuda)], rows["cpu"]
    assert len(cpu) == 8 * 7  # every iteration runs: a header and six stages each
    assert [r.split()[0] for r in card] == [r.split()[0] for r in cpu]
    assert all(float(r.split()[1]) > 0 for r in card if r.startswith("BA_pose"))


@pytest.mark.cuda
def test_ate_rmse_device_cuda_matches_host(cuda):
    rng = np.random.default_rng(3)
    gt = synthetic.smooth_trajectory(60)
    traj = torch.tensor(np.stack([p.t for p in gt]) + rng.normal(0, 2e-5, (60, 3)),
                        dtype=torch.float32, device=cuda)
    host = synthetic.ate_rmse([synthetic.SE3(None, t) for t in traj.cpu().numpy()], gt)
    dev = synthetic.ate_rmse_device(traj, np.stack([p.t for p in gt]))
    assert dev.device.type == "cuda"
    assert abs(float(dev) - host) <= 1e-6 * host


@pytest.mark.cuda
def test_timing_regions_add_no_synchronization(cuda):
    """Unflagged timed regions record CUDA events and fold them in when
    they complete: the same loop with and without them makes the same
    stream, device and event synchronizations (counted as cli.py's
    --profile summary counts them; the profiler makes its own)."""
    from torch.profiler import ProfilerActivity, profile

    from badslam_torch.utils.timing import Timing

    def syncs(timed: bool) -> dict:
        x = torch.randn(1 << 20, device=cuda)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                if timed:
                    with Timing.time("outer", device=cuda), Timing.time("inner", device=cuda):
                        x = torch.sin(x) * 1.0001
                else:
                    x = torch.sin(x) * 1.0001
        return {e.key: e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                             "cudaEventSynchronize")}

    Timing.reset()
    assert syncs(timed=True) == syncs(timed=False)
    assert Timing.stats("inner").count == Timing.stats("outer").count == 50
    assert Timing.stats("outer").total >= Timing.stats("inner").total > 0
    Timing.reset()


@pytest.mark.cuda
def test_while_node_runs_its_body_while_the_flag_holds(cuda):
    """A WHILE node captured around PyTorch work: its body runs until the
    flag it writes is false (a count chosen on the card), and not at all
    when the flag starts false."""
    from badslam_torch.ops.conditional import WhileNodes

    limit = torch.zeros((), dtype=torch.int32, device=cuda)
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    total = torch.zeros(1000, device=cuda)
    start = torch.zeros((), dtype=torch.bool, device=cuda)
    nodes = WhileNodes(cuda)
    stream = torch.cuda.Stream(cuda)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        count.zero_()
        total.zero_()
        flag = start.clone()
        with nodes.while_(flag):
            total.add_(torch.ones_like(total) * 2.0)
            count.add_(1)
            flag.copy_(count < limit)
        graph.capture_end()
    graph.instantiate()
    torch.cuda.current_stream(cuda).wait_stream(stream)
    assert nodes.count == 1 and nodes.body_node_counts()[1] >= 3
    for n, first in ((7, True), (1, True), (5, False)):
        limit.fill_(n)
        start.fill_(first)
        graph.replay()
        torch.cuda.synchronize()
        runs = n if first else 0
        assert int(count) == runs and float(total[0]) == 2.0 * runs


# The steady frame's cameras: the tests' 160x120 and the ETH3D SLAM camera's
# 739x458 (K1 stages every row unaligned, the pyramid drops a column or a
# row at each level, the principal point 42 rows above the centre).
STEADY_CAMERAS = {
    "160x120": synthetic.default_camera(160, 120),
    "eth3d_739x458": PinholeCamera(fx=726.3, fy=726.3, cx=355.1, cy=187.0, width=739,
                                   height=458),
}


def _steady_sequence(tmp_path, frames=16, camera="160x120"):
    path = str(tmp_path / "steady_seq")
    synthetic.write_tum_dataset(
        path, STEADY_CAMERAS[camera],
        synthetic.random_plane_scene(np.random.default_rng(5), 6),
        synthetic.smooth_trajectory(frames, scale=0.003))
    return path


def _steady_slam(path, device, graph=True, **kw):
    """A front end on a 160x120 sequence with keyframes every 6 frames; with
    `graph` false the steady frames call the same function eagerly with the
    host-read loop."""
    from badslam_torch.config import BadSlamConfig
    from badslam_torch.frontend import BadSlam
    from badslam_torch.io.dataset import load_tum_dataset

    config = BadSlamConfig(num_scales=4, keyframe_interval=6, max_surfel_count=1 << 14,
                           enable_loop_detection=False, fps_restriction=0, **kw)
    slam = BadSlam(config, load_tum_dataset(path), device)
    if not graph:
        slam.steady_graph = None
    return slam


@pytest.mark.cuda
@pytest.mark.parametrize("camera, frames", [("160x120", 13), ("eth3d_739x458", 6)])
def test_steady_graph_replay_matches_eager_call(cuda, tmp_path, camera, frames):
    """Every frame after the first as a replay of the steady frame's CUDA
    graphs (chunks of 5 frames and the keyframe frames, parallel BA),
    against the eager call of the same function with the host-read loop:
    equal poses, equal Gauss-Newton iterations and exact launch counts (K1
    once per frame, K2 and H1 as often as the eager run); the preprocessing
    stamp runs once per replay."""
    from badslam_torch.utils.timing import Timing

    path = _steady_sequence(tmp_path, frames, camera)
    runs = []
    for graph in (True, False):
        Timing.reset()
        slam = _steady_slam(path, cuda, graph)
        kernels.reset_launch_counts()
        slam.run()
        torch.cuda.synchronize()
        runs.append((slam, dict(kernels.launch_counts), Timing.snapshot()))
    Timing.reset()
    (g, lg, timers), (e, le, _) = runs
    cam = STEADY_CAMERAS[camera]
    assert (g.cam.width, g.cam.height) == (cam.width, cam.height)
    assert g.steady_graph.replays == frames - 1
    assert g.chunks_processed == e.chunks_processed == frames // 6
    torch.testing.assert_close(g.traj_q, e.traj_q, atol=1e-6, rtol=0)
    torch.testing.assert_close(g.traj_t, e.traj_t, atol=1e-6, rtol=0)
    assert lg[kernels.BILATERAL] == le[kernels.BILATERAL] == frames
    assert lg[kernels.GATHER] == le[kernels.GATHER] > 0
    assert lg[kernels.TRACK_COEFFS] == le[kernels.TRACK_COEFFS] > 0
    assert g.steady_gn_iterations() == e.steady_gn_iterations() > 0
    caps = g.steady_graph.captures
    assert [c["test_two"] for c in caps] == [False, True]
    assert all(c["while_nodes"] == 4 and c["nodes"] > c["kernel_nodes"] > 0 for c in caps)
    assert timers["steady frame: preprocess [graph]"][0] == g.steady_graph.replays
    assert 0 < timers["steady frame: preprocess [graph]"][1] \
        < timers["steady frame [graph]"][1]


@pytest.mark.cuda
def test_steady_frames_make_no_host_sync(cuda, tmp_path):
    """With its graphs captured, a chunk of steady frames and single steady
    frames run under torch.cuda.set_sync_debug_mode("error"): no read, no
    synchronizing copy (BA off, so nothing else runs between them)."""
    slam = _steady_slam(_steady_sequence(tmp_path), cuda,
                        max_num_ba_iterations_per_keyframe=0)
    marks = []
    slam.process_frame(0)
    slam._process_chunk(1, 5, marks)  # captures both graphs
    slam.process_frame(6)  # a keyframe
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slam._process_chunk(7, 5, marks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    slam.process_frame(12)  # a keyframe
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in (13, 14, 15):
            slam.process_frame(i)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert slam.has_pose[:16].all() and len(slam.steady_graph.captures) == 2
    assert slam.steady_graph.replays == 15
    assert np.isfinite(slam.traj_t.cpu().numpy()).all()


@pytest.mark.cuda
def test_steady_graph_recaptures_on_new_intrinsics(cuda, tmp_path):
    """A new camera (as self-calibration sets one) captures the steady frame
    anew, since the intrinsics are baked into the graph; the replays then
    equal the eager call with the new camera."""
    path = _steady_sequence(tmp_path)
    slams = [_steady_slam(path, cuda, graph, max_num_ba_iterations_per_keyframe=0)
             for graph in (True, False)]
    for slam in slams:
        for i in range(4):
            slam.process_frame(i)
        c = slam.cam
        slam.cam = c.with_intrinsics(c.fx * 1.002, c.fy, c.cx + 0.5, c.cy)
        slam.cams_pyramid = tuple(slam.cam.pyramid_level(s) for s in range(4))
        for i in range(4, 6):
            slam.process_frame(i)
    g, e = slams
    assert [c["test_two"] for c in g.steady_graph.captures] == [False, True, True]
    torch.testing.assert_close(g.traj_q, e.traj_q, atol=1e-6, rtol=0)
    torch.testing.assert_close(g.traj_t, e.traj_t, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_ba_graph_replays_equal_the_eager_call(cuda, tmp_path):
    """Every BA call of a run (keyframe calls and drains) as a replay of its
    captured graph, against the eager call of the same function with the
    host loops: the same poses, iterations, surfels and K2 launches."""
    path = _steady_sequence(tmp_path)
    runs = []
    for graph in (True, False):
        slam = _steady_slam(path, cuda, max_num_ba_iterations_per_keyframe=4)
        if not graph:
            slam.ba_graph = None
        kernels.reset_launch_counts()
        slam.run()
        torch.cuda.synchronize()
        runs.append((slam, dict(kernels.launch_counts)))
    (g, lg), (e, le) = runs
    torch.testing.assert_close(g.traj_q, e.traj_q, atol=1e-6, rtol=0)
    torch.testing.assert_close(g.traj_t, e.traj_t, atol=1e-6, rtol=0)
    iterations = g.direct_ba.iterations_run
    assert iterations == e.direct_ba.iterations_run and sum(iterations) > 0
    assert g.direct_ba.surfel_count == e.direct_ba.surfel_count > 0
    assert lg[kernels.GATHER] == le[kernels.GATHER] > 0
    assert g.ba_graph.replays == len(iterations) and len(g.ba_graph.captures) >= 2
    assert all(c["while_nodes"] >= 4 and c["nodes"] > c["kernel_nodes"] > 0
               for c in g.ba_graph.captures)


@pytest.mark.cuda
def test_ba_graph_replays_make_no_host_sync(cuda, tmp_path):
    """With both call kinds captured, a replayed drain and keyframe call,
    each with the trajectory deformation after it, run under
    torch.cuda.set_sync_debug_mode("error") with sync_surfel_bucket false."""
    slam = _steady_slam(_steady_sequence(tmp_path), cuda,
                        max_num_ba_iterations_per_keyframe=4, sync_surfel_bucket=False)
    slam.run(0, 13)  # keyframe calls at 6 and 12, a chunk's drain at 11
    bag, ba = slam.ba_graph, slam.direct_ba
    captures, replays = len(bag.captures), bag.replays
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slam._drain_queued_ba(2, 12)
        old = slam._remember_keyframe_poses()
        ba.bundle_adjustment(max_iterations=2, loop=slam.ba_loop, graph=bag)
        slam._apply_ba_pose_updates(*old)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert len(bag.captures) == captures and bag.replays == replays + 2
    assert np.isfinite(slam.traj_t.cpu().numpy()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [2048.0, 0.0], ids=["integrated", "streamed"])
def test_mesh_ba_graph_replays_equal_the_eager_call(cuda, tmp_path, budget):
    """BA over a 2-shard mesh of the card: every call (keyframe calls and
    drains) as a replay of its captured graph, against the eager call of
    the same mesh function with the host loops: the same poses (1e-6),
    iterations, surfels, and K2 launches per shard."""
    from badslam_torch.config import BadSlamConfig
    from badslam_torch.frontend import BadSlam
    from badslam_torch.io.dataset import load_tum_dataset
    from badslam_torch.parallel import make_mesh

    path = _steady_sequence(tmp_path)
    runs = []
    for graph in (True, False):
        config = BadSlamConfig(num_scales=4, keyframe_interval=6, max_surfel_count=1 << 14,
                               enable_loop_detection=False, fps_restriction=0,
                               max_num_ba_iterations_per_keyframe=4, n_devices=2,
                               plane_replication_budget_mb=budget)
        slam = BadSlam(config, load_tum_dataset(path), cuda,
                       mesh=make_mesh(devices=[cuda, cuda]))
        if not graph:
            slam.ba_graph = None
        kernels.reset_launch_counts()
        slam.run()
        torch.cuda.synchronize()
        runs.append((slam, dict(kernels.launch_tags[kernels.GATHER])))
    (g, kg), (e, ke) = runs
    assert g.direct_ba._streaming == e.direct_ba._streaming == (budget == 0.0)
    torch.testing.assert_close(g.traj_q, e.traj_q, atol=1e-6, rtol=0)
    torch.testing.assert_close(g.traj_t, e.traj_t, atol=1e-6, rtol=0)
    iterations = g.direct_ba.iterations_run
    assert iterations == e.direct_ba.iterations_run and sum(iterations) > 0
    assert g.direct_ba.surfel_count == e.direct_ba.surfel_count > 0
    assert kg == ke and kg.get(0, 0) > 0 and kg.get(1, 0) > 0
    assert g.ba_graph.replays == len(iterations)
    assert all(c["shards"] == 2 and c["streamed"] == (budget == 0.0)
               and c["while_nodes"] >= 4 for c in g.ba_graph.captures)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [2048.0, 0.0], ids=["integrated", "streamed"])
def test_mesh_ba_graph_replays_make_no_host_sync(cuda, tmp_path, budget):
    """With both call kinds captured over the 2-shard mesh, a replayed
    drain and keyframe call run under torch.cuda.set_sync_debug_mode
    ("error") with sync_surfel_bucket false."""
    from badslam_torch.config import BadSlamConfig
    from badslam_torch.frontend import BadSlam
    from badslam_torch.io.dataset import load_tum_dataset
    from badslam_torch.parallel import make_mesh

    config = BadSlamConfig(num_scales=4, keyframe_interval=6, max_surfel_count=1 << 14,
                           enable_loop_detection=False, fps_restriction=0,
                           max_num_ba_iterations_per_keyframe=4, n_devices=2,
                           plane_replication_budget_mb=budget, sync_surfel_bucket=False)
    slam = BadSlam(config, load_tum_dataset(_steady_sequence(tmp_path)), cuda,
                   mesh=make_mesh(devices=[cuda, cuda]))
    slam.run(0, 13)  # keyframe calls at 6 and 12, a chunk's drain at 11
    bag, ba = slam.ba_graph, slam.direct_ba
    captures, replays = len(bag.captures), bag.replays
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slam._drain_queued_ba(2, 12)
        old = slam._remember_keyframe_poses()
        ba.bundle_adjustment(max_iterations=2, loop=slam.ba_loop, graph=bag)
        slam._apply_ba_pose_updates(*old)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert len(bag.captures) == captures and bag.replays == replays + 2
    assert np.isfinite(slam.traj_t.cpu().numpy()).all()


@pytest.mark.cuda
def test_ba_graph_recaptures_when_a_bucket_changes(cuda, tmp_path):
    """A larger surfel bucket captures the call anew and frees the graph of
    the smaller one; the replay equals the eager call on the same state."""
    path = _steady_sequence(tmp_path)
    slams = [_steady_slam(path, cuda, max_num_ba_iterations_per_keyframe=4,
                          surfel_bucket_base=1024) for _ in range(2)]
    slams[1].ba_graph = None
    before = []
    for slam in slams:
        slam.run(0, 8)
        ba = slam.direct_ba
        before.append(ba.surfel_bucket())
        ba.known_surfel_bound = ba._creation_bound = 2 * before[-1] + 1
    bag = slams[0].ba_graph
    captures = len(bag.captures)
    for slam in slams:
        slam.direct_ba.bundle_adjustment(max_iterations=2, increase_ba_iteration_count=False,
                                         graph=slam.ba_graph)
    torch.cuda.synchronize()
    g, e = (slam.direct_ba for slam in slams)
    assert len(bag.captures) == captures + 1
    assert bag.captures[-1]["surfel_bucket"] == g.surfel_bucket() > before[0] == before[1]
    assert {k.surfel_bucket for k in bag._graphs} == {g.surfel_bucket()}
    torch.testing.assert_close(g.keyframes.q, e.keyframes.q, atol=1e-6, rtol=0)
    torch.testing.assert_close(g.keyframes.t, e.keyframes.t, atol=1e-6, rtol=0)
    assert g.surfel_count == e.surfel_count > 0


def _closure_state(cuda, tmp_path):
    """tests/test_torch_closure_readfree.py's 13-frame run at 96x80 on the
    card, loop detection on the front end's thread; returns the front end
    and a copy of the state an attempt writes."""
    from badslam_torch.config import BadSlamConfig
    from badslam_torch.frontend import BadSlam
    from badslam_torch.io.dataset import load_tum_dataset

    path = str(tmp_path / "closure")
    synthetic.write_tum_dataset(path, synthetic.default_camera(96, 80),
                                synthetic.random_plane_scene(np.random.default_rng(4), 3),
                                synthetic.smooth_trajectory(13, scale=0.002))
    config = BadSlamConfig(num_scales=3, keyframe_interval=4,
                           max_num_ba_iterations_per_keyframe=2, max_surfel_count=1 << 13,
                           tracking_max_iterations=8, enable_loop_detection=True,
                           parallel_loop_detection=False)
    slam = BadSlam(config, load_tum_dataset(path), cuda)
    for i in range(13):
        slam.process_frame(i)
    ks = slam.direct_ba.keyframes
    return slam, [x.clone() for x in (ks.q, ks.t, slam.traj_q, slam.traj_t)]


def _closure_attempt(slam, saved, accept, sync_check=False):
    """The state restored, then the last keyframe closed onto the first with
    RANSAC's pose the identity: with drift injected into the last keyframe
    (accepted) or with 40 keypoints and none (the necessity gate rejects);
    with `sync_check` the attempt alone runs under
    torch.cuda.set_sync_debug_mode("error"). Returns the state before and
    after it."""
    from badslam_torch.geometry import se3
    from badslam_torch.geometry import se3_np as s3

    ks = slam.direct_ba.keyframes
    for dst, src in zip((ks.q, ks.t, slam.traj_q, slam.traj_t), saved):
        dst.copy_(src)
    order = ks.live_slots_in_time_order()
    last, feats = order[-1], slam.loop_detector.features
    own = feats[last]
    if accept:
        drift = synthetic.pose(tx=0.08, ty=-0.04, rz=0.02)  # keypoints move ~2 px
        true = s3.SE3(ks.q[last].double().cpu().numpy(), ks.t[last].double().cpu().numpy())
        moved = s3.mul(s3.SE3(np.asarray(drift.q, float), np.asarray(drift.t, float)), true)
        ks.set_pose(last, se3.SE3(torch.tensor(moved.q, dtype=torch.float32),
                                  torch.tensor(moved.t, dtype=torch.float32)))
    else:
        rng = np.random.default_rng(0)
        feats[last] = own._replace(points_local=np.stack(
            [rng.uniform(-0.4, 0.4, 40), rng.uniform(-0.3, 0.3, 40),
             rng.uniform(1.0, 2.0, 40)], -1).astype(np.float32))
    before = [x.clone() for x in (ks.q, ks.t, slam.traj_q, slam.traj_t)]
    torch.cuda.synchronize()
    try:
        if sync_check:
            torch.cuda.set_sync_debug_mode("error")
        slam._attempt_loop_closure(last, order[0], s3.identity())
    finally:
        torch.cuda.set_sync_debug_mode(0)
        feats[last] = own
    torch.cuda.synchronize()
    return before, [x.clone() for x in (ks.q, ks.t, slam.traj_q, slam.traj_t)]


@pytest.mark.cuda
@pytest.mark.parametrize("accept", [True, False], ids=["accepted", "rejected"])
def test_closure_graph_replay_equals_the_eager_call(cuda, tmp_path, accept):
    """A closure attempt as a replay of its captured graph against the eager
    call of the same function with the host loop, on one state: poses and
    trajectory max |dq|, |dt| <= 1e-6, the same gates, the same H1 and K2
    launches (H1 in the refinements); a rejected replay leaves every pose
    bit-identical."""
    slam, saved = _closure_state(cuda, tmp_path)
    graph, out = slam.closure_graph, {}
    for name in ("replay", "eager"):
        slam.closure_graph = graph if name == "replay" else None
        slam.loop_closure_count = 0
        kernels.reset_launch_counts()
        before, after = _closure_attempt(slam, saved, accept)
        kernels.flush_launch_counts()
        out[name] = (after, slam.closure_attempts[-1], slam.loop_closure_count,
                     (kernels.launch_counts[kernels.TRACK_COEFFS],
                      kernels.launch_counts[kernels.GATHER]))
    (g, ga, gn, gk), (e, ea, en, ek) = out["replay"], out["eager"]
    assert graph.replays == 1 and len(graph.captures) == 1
    assert graph.captures[0]["while_nodes"] == 2 * 3
    assert ga == ea and gn == en == int(accept) and gk == ek and gk[0] > 0
    for a, b in zip(g, e):
        assert float((a - b).abs().max()) <= 1e-6
    if not accept:
        assert all(torch.equal(a, b) for a, b in zip(before, g))


@pytest.mark.cuda
def test_closure_graph_replays_make_no_host_sync(cuda, tmp_path):
    """With the attempt's graph captured, a replayed accepting and a replayed
    rejecting attempt run under torch.cuda.set_sync_debug_mode("error")."""
    slam, saved = _closure_state(cuda, tmp_path)
    _closure_attempt(slam, saved, True)  # captures
    graph = slam.closure_graph
    captures = len(graph.captures)
    for accept in (True, False):
        _closure_attempt(slam, saved, accept, sync_check=True)
    assert len(graph.captures) == captures and graph.replays == 3
    assert slam.loop_closure_count == 2
    assert [(a["consistent"], a["needed"]) for a in slam.closure_attempts] == [
        (True, True), (True, True), (True, False)]


@pytest.mark.cuda
def test_stamps_time_a_while_node_and_its_replay(cuda):
    """Device stamps captured in a toy graph (a whole-replay region with a
    ring entry around a Timing region and a WHILE node whose body is
    stamped too): the body's row runs n times a replay, the region's, the
    WHILE node's and the replay's once (the region as "<name> [graph]", with
    no CUDA events), the device timers agree within 5% with CUDA events
    around the replays, and the ring holds each replay with its frame index,
    in order on the host clock."""
    from badslam_torch.ops.conditional import DeviceControl, WhileNodes
    from badslam_torch.utils.timing import Timing, stamped

    Timing.reset()
    a = torch.randn(4096, 4096, device=cuda) / 64.0
    x = torch.randn(4096, 4096, device=cuda)
    limit = torch.zeros((), dtype=torch.int64, device=cuda)
    frame = torch.full((1,), 7, dtype=torch.int64, device=cuda)
    nodes = WhileNodes(cuda)
    control = DeviceControl(nodes, torch.zeros(1, dtype=torch.int64, device=cuda),
                            scope="toy")
    stream = torch.cuda.Stream(cuda)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        a @ x  # the cuBLAS handle and workspace, before the capture
        graph.capture_begin(capture_error_mode="thread_local")
        with stamped("toy replay", cuda, ring=True, frame=frame):
            with Timing.time("toy region", device=cuda) as span:  # stamped, not events
                i = torch.zeros((), dtype=torch.int64, device=cuda)
                flag = i < limit
            with control.body(flag, "work"), stamped("toy body", cuda):
                x.copy_(torch.tanh(a @ x))
                i.add_(1)
                flag.copy_(i < limit)
        graph.capture_end()
    graph.instantiate()
    torch.cuda.current_stream(cuda).wait_stream(stream)
    event_ms = []
    for n in (5, 20):
        limit.fill_(n)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        event_ms.append(start.elapsed_time(end))
    kernels.flush_launch_counts()
    body, node = Timing.stats("toy body [graph]"), Timing.stats("toy: work [graph]")
    whole = Timing.stats("toy replay [graph]")
    assert body.count == 25 and node.count == whole.count == 2
    assert span.stamped and Timing.stats("toy region [graph]").count == 2
    assert Timing.stats("toy region") is None
    assert int(control.units[0]) == 25
    assert whole.total >= node.total >= body.total > 0
    assert abs(1e3 * whole.total - sum(event_ms)) <= 0.05 * sum(event_ms)
    assert abs(1e3 * body.total - sum(event_ms)) <= 0.05 * sum(event_ms)
    replays = Timing.device_timeline(cuda)
    assert [(r["graph"], r["frame"]) for r in replays] == [("toy replay", 7)] * 2
    assert replays[0]["end_ns"] <= replays[1]["start_ns"]
    for r, ms in zip(replays, event_ms):
        assert abs((r["end_ns"] - r["start_ns"]) * 1e-6 - ms) <= 0.05 * ms
    Timing.reset()


def _stamped_run(path, cuda, stamping: bool):
    """The 16-frame steady sequence with keyframe BA (4 iterations) on the
    card, its graphs captured with the device stamps or without."""
    from badslam_torch.utils.timing import Timing

    Timing.reset()
    Timing.stamping = stamping
    try:
        slam = _steady_slam(path, cuda, max_num_ba_iterations_per_keyframe=4)
        slam.run()
        torch.cuda.synchronize()
        return slam, Timing.snapshot()
    finally:
        Timing.stamping = True
        Timing.reset()


@pytest.mark.cuda
def test_stamps_leave_poses_and_map_bit_identical(cuda, tmp_path):
    """The same run with its graphs captured with the device stamps and
    without: bit-identical trajectory, keyframe poses and map, the same BA
    iterations; with the stamps, the [graph] timers count the replays, the
    iterations and the passes over the surfel bucket."""
    path = _steady_sequence(tmp_path)
    (s, timers), (u, plain) = (_stamped_run(path, cuda, True),
                               _stamped_run(path, cuda, False))
    assert torch.equal(s.traj_q, u.traj_q) and torch.equal(s.traj_t, u.traj_t)
    ks, ku = s.direct_ba.keyframes, u.direct_ba.keyframes
    assert torch.equal(ks.q, ku.q) and torch.equal(ks.t, ku.t)
    for a, b in zip(s.direct_ba.surfels, u.direct_ba.surfels):
        assert torch.equal(a, b)
    iterations = s.direct_ba.iterations_run
    assert iterations == u.direct_ba.iterations_run and sum(iterations) > 0
    assert not any(name.endswith("[graph]") for name in plain)
    assert timers["steady frame [graph]"][0] == s.steady_graph.replays
    assert timers["steady frame: preprocess [graph]"][0] == s.steady_graph.replays
    assert timers["BA call [graph]"][0] == s.ba_graph.replays
    assert timers["BA iteration [graph]"][0] == sum(iterations)
    assert timers["steady frame launch [host]"][0] == s.steady_graph.replays
    for stage in ("BA pose optimization", "BA geometry optimization", "BA surfel upkeep",
                  "BA scheme end"):
        assert timers[f"{stage} [graph]"][1] > 0
    stages = sum(timers[f"{stage} [graph]"][1] for stage in (
        "BA pose optimization", "BA geometry optimization", "BA surfel upkeep",
        "BA scheme end"))
    assert stages <= timers["BA call [graph]"][1]
    rows, live = timers["BA surfel rows [graph]"][0], timers["BA live surfels [graph]"][0]
    assert rows >= live > 0
    assert {c["reason"] for c in s.ba_graph.captures} and \
        s.steady_graph.captures[0]["reason"] == "first"


@pytest.mark.cuda
def test_stamps_add_no_synchronization(cuda, tmp_path):
    """A run's stream and device synchronizations and device copies,
    counted as cli.py's --profile summary counts them, are the same with
    the device stamps captured and without. (Event synchronizations are
    left out: reading a frame's span waits only where its end has not
    completed yet, which timing decides.)"""
    from torch.profiler import ProfilerActivity, profile

    from badslam_torch.utils.timing import Timing

    path = _steady_sequence(tmp_path)
    counts = []
    for stamping in (True, False):
        Timing.stamping = stamping
        try:
            slam = _steady_slam(path, cuda, max_num_ba_iterations_per_keyframe=4)
            slam.run(0, 7)  # captures
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                slam.run(7, 13)
                slam.run(13, 16)
            counts.append({e.key: e.count for e in prof.key_averages()
                           if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                        "cudaMemcpyAsync")})
        finally:
            Timing.stamping = True
            Timing.reset()
    assert counts[0] == counts[1], counts


@pytest.mark.cuda
def test_device_timeline_lines_up_with_the_profiler(cuda, tmp_path):
    """Under torch.profiler, the steady graph's first stamp kernel of the
    first profiled replay (stamp_replay_begin, which CUPTI records under the
    replay's graph launch) starts within 20 us of its own globaltimer
    reading mapped onto the profiler's clock, and each idle gap between two
    replays (stamp_replay_end to the next stamp_replay_begin) is the same
    within 20 us on both clocks; the timeline holds every steady replay of
    the profiled frames, in order, with its frame index, and one replay for
    each graph launch. (CUPTI does not record every kernel of a graph: a
    gap whose stamps it left out is not compared.)"""
    import time
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from badslam_torch.utils.timing import PROFILER_CLOCK, Timing

    Timing.reset()
    slam = _steady_slam(_steady_sequence(tmp_path), cuda,
                        max_num_ba_iterations_per_keyframe=0)
    slam.run(0, 7)
    torch.cuda.synchronize()
    t0 = time.clock_gettime_ns(PROFILER_CLOCK)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        slam.run(7, 13)
        torch.cuda.synchronize()
    replays = [r for r in slam.device_timeline() if r["start_ns"] >= t0]
    steady = [r for r in replays if r["graph"] == "steady frame"]
    assert [r["frame"] for r in steady] == list(range(7, 13))  # the keyframe's too
    events = list(prof.profiler.kineto_results.events())
    recorded = defaultdict(list)
    for ev in events:
        if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation():
            recorded[ev.correlation_id()].append((ev.start_ns(), ev.name()))
    launches = sorted((ev.start_ns(), ev.correlation_id()) for ev in events
                      if ev.device_type() == DeviceType.CPU
                      and ev.name().startswith("cudaGraphLaunch"))
    assert len(launches) == len(replays), (len(launches), [r["graph"] for r in replays])
    gaps = {}
    for r, (_, correlation) in zip(replays, launches):
        if r["graph"] != "steady frame":
            continue
        for start, name in recorded.get(correlation, []):
            if "stamp_replay_begin" in name:
                gaps[(r["frame"], "begin")] = start - r["start_ns"]
            elif "stamp_replay_end" in name:
                gaps[(r["frame"], "end")] = start - r["end_ns"]
    # Inside a replay CUPTI's kernel times part from the globaltimer (by up to
    # hundreds of microseconds a replay, PERF.md §6), so the first replay's
    # start is held, and each idle gap between two replays.
    begins = {f: gap for (f, side), gap in gaps.items() if side == "begin"}
    ends = {f: gap for (f, side), gap in gaps.items() if side == "end"}
    assert abs(begins[7]) <= 20_000, str(sorted(gaps.items()))
    across = [begins[f + 1] - ends[f] for f in ends if f + 1 in begins]
    assert len(across) >= len(steady) // 2, str(sorted(gaps.items()))
    assert all(abs(gap) <= 20_000 for gap in across), str(sorted(gaps.items()))
    Timing.reset()


@pytest.mark.cuda
def test_capture_ranges_replace_stage_ranges(cuda, tmp_path):
    """Under torch.profiler, a run that captures its steady and BA graphs
    opens capture/steady_graph and capture/ba_graph, and no stage range
    (the BA stages', the steady frame's, the tracker's) inside either."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    slam = _steady_slam(_steady_sequence(tmp_path), cuda,
                        max_num_ba_iterations_per_keyframe=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        slam.run(0, 13)
        torch.cuda.synchronize()
    ranges = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
              for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CPU and ev.is_user_annotation()]
    captures = [r for r in ranges if r[2].startswith("capture/")]
    assert {r[2] for r in captures} == {"capture/steady_graph", "capture/ba_graph"}
    stages = [r for r in ranges if r[2].startswith(("ba/", "gn_iteration/"))
              or r[2] in ("preprocess", "pyramid", "track", "duel")]
    for lo, hi, name in captures:
        inside = [s[2] for s in stages if lo <= s[0] <= hi]
        assert not inside, (name, inside[:5])
