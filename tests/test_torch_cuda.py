"""badslam_torch on the card: the CUDA kernels (K1 bilateral filter, K2
image gather, K3 one-hot gather) against their plain PyTorch versions, and
the CUDA path against the CPU path of the same modules.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so on a GPU machine without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances:
  * K2 and K3 vs plain version: exact (a gather computes nothing).
  * K1 vs plain version: atol 1e-5 (depths of 0.5-3 m; sums in the same
    order and IEEE reciprocals in both; the kernel's exponential is
    ex2.approx, within 2 ulp, which tests/test_torch_bilateral.py shows
    moves the output by ~1e-6 at most).
  * preprocess on CUDA vs CPU: atol 1e-5 on depths, 1e-4 on normals (the
    normals amplify the depths' ~1e-6 differences, as against JAX).
  * tracked pose on CUDA vs CPU: atol 1e-4, the slice's hold.
  * bundle adjustment on CUDA vs CPU: keyframe poses atol 1e-4, the same
    number of iterations, surfel counts within 1% (creation and deletion
    are threshold tests on float values).
  * a loop closure's gates, pose graph and deformation on CUDA vs CPU:
    poses and trajectory atol 1e-5, the same decisions.
"""

import numpy as np
import pytest
import torch

from badslam_torch import synthetic
from badslam_torch.ops import kernels
from badslam_torch.ops.preprocess import bilateral_filter_and_cutoff, preprocess_frame
from badslam_torch.ops.pyramid import build_pyramid
from badslam_torch.tracking.pairwise import track_frame_pairwise


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _depth(seed, shape, max_depth=2.5):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    d[rng.uniform(size=shape) < 0.15] = 0.0
    d[rng.uniform(size=shape) < 0.05] = max_depth + 2.0
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (67, 160), (5, 3), (1, 1), (33, 70)])
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


def _bundle_adjustment(device, window=None):
    """Two rendered keyframes, the first with its surfels, the second
    starting off its true pose; one BA call of up to 8 iterations, or of
    exactly 3 in the fixed keyframe window `window` (the final BA's)."""
    from badslam_torch.ba.scheme import DirectBA
    from badslam_torch.config import BadSlamConfig

    cam = synthetic.default_camera(160, 120)
    scene = synthetic.random_plane_scene(np.random.default_rng(13), 3)
    truth = (synthetic.pose(), synthetic.pose(tx=0.03, ty=0.01, rz=0.01))
    start = (truth[0], synthetic.pose(tx=0.034, ty=0.007, rz=0.011))
    ba = DirectBA(cam, BadSlamConfig(max_surfel_count=1 << 14),
                  surfel_capacity=1 << 14, device=device)
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
def test_bundle_adjustment_cuda_matches_cpu(cuda, window):
    before = kernels.launch_counts[kernels.GATHER]
    on_card, iters_card = _bundle_adjustment(cuda, window)
    torch.cuda.synchronize()
    assert kernels.launch_counts[kernels.GATHER] > before
    on_cpu, iters_cpu = _bundle_adjustment("cpu", window)
    assert iters_card == iters_cpu >= 1
    assert torch.equal(on_card.keyframes.activation[:2].cpu(), on_cpu.keyframes.activation[:2])
    for name in ("q", "t"):
        torch.testing.assert_close(getattr(on_card.keyframes, name)[:2].cpu(),
                                   getattr(on_cpu.keyframes, name)[:2], atol=1e-4, rtol=0)
    n_card, n_cpu = on_card.surfel_count, on_cpu.surfel_count
    assert n_cpu > 500 and abs(n_card - n_cpu) <= 0.01 * n_cpu


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

        out.append(apply_closure(
            dev(q), dev(t), dev(np.arange(16)), 15, 0,
            dev(np.stack([r.q for r in refs]), torch.float32),
            dev(np.stack([r.t for r in refs]), torch.float32),
            dev(np.ones(3, bool)), dev(pts), dev(np.ones(60, bool)), dev(traj_q), dev(traj_t),
            dev(prev), dev(nxt), dev(alpha), dev(kf_slot), cam))
    card, cpu = out
    assert card.ok and cpu.ok
    for name in ("kq", "kt", "traj_q", "traj_t"):
        torch.testing.assert_close(getattr(card, name).cpu(), getattr(cpu, name), atol=1e-5, rtol=0)
    assert float((card.kt.cpu() - torch.from_numpy(t)).abs().max()) > 1e-2
