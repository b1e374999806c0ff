"""The image-gather probe on the card: K2, K3, the library gather and the
tracker's accumulation at VGA.

Port of ``tools/probe_pallas_gather.py:187 main``. Run as

    python -m badslam_torch.probe_gather

It needs CUDA and raises without it. On the probe's near-coherent 480x640
index field (`make_inputs`) it times:

* the library gather, ``torch.take`` on the flat image (the counterpart of
  the probe's XLA gather);
* K2 (``kernels.gather_cuda``), with its max abs error against the
  library gather;
* K3 (``kernels.gather_onehot_cuda``), with its max abs error against the
  exact gather and the number of pixels whose row lies outside the one-hot
  window (those read 0 by construction);
* the tracker's ``accumulate_pose_coeffs`` at VGA on the probe's rendered
  pair (identity and tx=0.01, ry=0.004 views of a 3-plane scene).

Each is timed as device time (a CUDA graph of repeated calls) and as eager
call latency, both with CUDA events (``cuda_timing``). Prints one JSON
line and returns the dict.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from badslam_torch import cuda_timing, synthetic
from badslam_torch.ops import kernels
from badslam_torch.ops.interp import ONEHOT_BLOCK_ROWS, ONEHOT_PAD
from badslam_torch.ops.preprocess import preprocess_frame
from badslam_torch.ops.pyramid import build_pyramid
from badslam_torch.tracking import pairwise

HEIGHT, WIDTH = 480, 640


def make_inputs(h: int, w: int, seed: int = 0):
    """A VGA-ish image and a near-coherent index field (every pixel moved
    by up to 3 pixels each way), the tracker's access pattern; as
    tools/probe_pallas_gather.py:49."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((h, w)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    px = np.clip(xs + rng.integers(-3, 4, size=(h, w)), 0, w - 1)
    py = np.clip(ys + rng.integers(-3, 4, size=(h, w)), 0, h - 1)
    return img, px.astype(np.int32), py.astype(np.int32)


def library_gather(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """The gather through PyTorch's library: the flat index (int64, as
    ``torch.take`` wants) and ``torch.take`` on the flat image, as the
    probe's XLA gather computes its index and takes (a yardstick; the port
    never calls it)."""
    return torch.take(img, py.to(torch.int64) * img.shape[1] + px.to(torch.int64))


def windowed_out(py: np.ndarray) -> int:
    """Pixels whose row index lies outside their block's one-hot window."""
    y = np.arange(py.shape[0])[:, None]
    lo = y // ONEHOT_BLOCK_ROWS * ONEHOT_BLOCK_ROWS - ONEHOT_PAD
    hi = lo + ONEHOT_BLOCK_ROWS + 2 * ONEHOT_PAD
    return int(np.sum((py < lo) | (py >= hi)))


def _timed(fn) -> dict:
    return {"device_ms": cuda_timing.device_ms(fn),
            "call_ms": cuda_timing.call_ms(fn)}


def _rendered_pair(device):
    cam = synthetic.default_camera(WIDTH, HEIGHT)
    scene = synthetic.random_plane_scene(np.random.default_rng(0), 3)
    levels = []
    for pose in (synthetic.pose(), synthetic.pose(tx=0.01, ry=0.004)):
        d, inten = synthetic.render_scene(cam, scene, pose)
        rgb = np.repeat(np.clip(inten[..., None] * 255.0, 0, 255)
                        .astype(np.uint8), 3, -1)
        frame = preprocess_frame(
            cam, torch.from_numpy(d).to(device), torch.from_numpy(rgb).to(device),
            max_depth=20.0, sigma_xy=1.5, radius_factor=2.0,
            sigma_inv_depth=0.005, a=torch.zeros((), device=device),
            cfactor=torch.zeros(((HEIGHT - 1) // 4 + 1, (WIDTH - 1) // 4 + 1),
                                device=device))
        levels.append(build_pyramid(frame.depth, frame.nx, frame.ny,
                                    frame.intensity, 1)[0])
    return cam, levels[0], levels[1]


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("badslam_torch.probe_gather needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    img_np, px_np, py_np = make_inputs(HEIGHT, WIDTH)
    img = torch.from_numpy(img_np).to(dev)
    px = torch.from_numpy(px_np).to(dev)
    py = torch.from_numpy(py_np).to(dev)
    want = torch.from_numpy(
        img_np.reshape(-1)[(py_np * WIDTH + px_np).reshape(-1)]
        .reshape(HEIGHT, WIDTH)).to(dev)
    results = {"device": torch.cuda.get_device_name(0), "shape": [HEIGHT, WIDTH]}

    ref = library_gather(img, px, py)
    results["library_gather"] = _timed(lambda: library_gather(img, px, py))

    img3, px2, py2 = img[None], px.reshape(1, -1), py.reshape(1, -1)
    out = kernels.gather_cuda(img3, px2, py2).reshape(HEIGHT, WIDTH)
    results["k2_gather"] = {
        "max_abs_err": float((out - ref).abs().max()),
        **_timed(lambda: kernels.gather_cuda(img3, px2, py2))}

    out = kernels.gather_onehot_cuda(img, px, py)
    results["k3_gather_onehot"] = {
        "max_abs_err": float((out - want).abs().max()),
        "windowed_out_pixels": windowed_out(py_np),
        **_timed(lambda: kernels.gather_onehot_cuda(img, px, py))}

    cam, base, tracked = _rendered_pair(dev)
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    t0 = torch.zeros(3, device=dev)
    acc = lambda: pairwise.accumulate_pose_coeffs(  # noqa: E731
        cam, base, tracked, q0, t0, 1.0, 40.0, True, True)
    H, _, count = acc()
    results["gn_accumulation_vga"] = {
        "residuals": int(count), "h_finite": bool(torch.isfinite(H).all()),
        **_timed(acc)}
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
