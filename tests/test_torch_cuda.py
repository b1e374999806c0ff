"""badslam_torch on the card: the CUDA kernels (K1 bilateral filter, K2
image gather, K3 one-hot gather) against their plain PyTorch versions, and
the CUDA path against the CPU path of the same modules.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so on a GPU machine without JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances:
  * K2 and K3 vs plain version: exact (a gather computes nothing).
  * K1 vs plain version: atol 1e-5 (depths of 0.5-3 m; IEEE division
    and expf in both, sums in the same order, so only FMA contraction and
    exp rounding differ).
  * preprocess on CUDA vs CPU: atol 1e-5 on depths, 1e-4 on normals (the
    normals amplify the depths' ~1e-6 differences, as against JAX).
  * tracked pose on CUDA vs CPU: atol 1e-4, the slice's hold.
  * bundle adjustment on CUDA vs CPU: keyframe poses atol 1e-4, the same
    number of iterations, surfel counts within 1% (creation and deletion
    are threshold tests on float values).
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
    d = torch.from_numpy(_depth(3, (50, 90), 4.0)).to(cuda)
    for sigma_xy, radius_factor, sigma_inv in ((1.0, 2.0, 0.01), (2.5, 2.0, 0.005)):
        out = kernels.bilateral_filter_and_cutoff_cuda(d, 4.0, sigma_xy, radius_factor, sigma_inv)
        ref = bilateral_filter_and_cutoff(d, 4.0, sigma_xy, radius_factor, sigma_inv)
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


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


def _bundle_adjustment(device):
    """Two rendered keyframes, the first with its surfels, the second
    starting off its true pose; one BA call of up to 8 iterations."""
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
    iterations = ba.bundle_adjustment(max_iterations=8)
    return ba, iterations


@pytest.mark.cuda
def test_bundle_adjustment_cuda_matches_cpu(cuda):
    before = kernels.launch_counts[kernels.GATHER]
    on_card, iters_card = _bundle_adjustment(cuda)
    torch.cuda.synchronize()
    assert kernels.launch_counts[kernels.GATHER] > before
    on_cpu, iters_cpu = _bundle_adjustment("cpu")
    assert iters_card == iters_cpu >= 1
    for name in ("q", "t"):
        torch.testing.assert_close(getattr(on_card.keyframes, name)[:2].cpu(),
                                   getattr(on_cpu.keyframes, name)[:2], atol=1e-4, rtol=0)
    n_card, n_cpu = on_card.surfel_count, on_cpu.surfel_count
    assert n_cpu > 500 and abs(n_card - n_cpu) <= 0.01 * n_cpu
