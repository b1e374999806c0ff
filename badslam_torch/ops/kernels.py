"""Hand-written CUDA kernels of the port: build, binding, dispatch, counts.

* K1, the bilateral depth filter with max-depth cutoff
  (``csrc/bilateral.cu``), replaces the Pallas TPU kernel
  ``badslam_tpu/ops/pallas_kernels.py:105 bilateral_filter_and_cutoff_pallas``.
* K2, the image gather at integer pixel indices (``csrc/gather.cu``),
  replaces ``tools/probe_pallas_gather.py:82 pallas_gather_rowblock``; it is
  the port's ``ops.interp.gather_nearest`` on a CUDA tensor.
* K3, the same gather as a windowed one-hot (``csrc/gather.cu``), replaces
  ``tools/probe_pallas_gather.py:120 pallas_gather_onehot``; only the probe
  (``badslam_torch.probe_gather``) runs it.

* Build: at first use, ``nvcc`` compiles the source in this checkout into a
  shared library with a plain C interface under ``badslam_torch/_build/``
  (listed in ``.gitignore``). The library name carries a hash of the source
  and the flags, so an edited source is rebuilt. Nothing is compiled or
  loaded when this module is imported.
* Binding: ``ctypes``, with ``c_void_p`` for device pointers and the CUDA
  stream (PyTorch's current stream).
* Dispatch (``bilateral_filter`` here, ``gather_nearest`` and
  ``gather_onehot`` in ``ops.interp``): a CPU tensor goes to the plain
  PyTorch version; a CUDA tensor goes to the kernel, which raises on
  anything it does not take. There is no fallback from a CUDA tensor to the
  plain version.
* Counts: ``launch_counts[name]`` goes up by one for each launch of that
  kernel, and nowhere else, so a run can show that it went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BILATERAL = "bilateral_filter_and_cutoff"
GATHER = "gather"
GATHER_ONEHOT = "gather_onehot"

# The CUDA source of each kernel, under csrc/.
SOURCES = {BILATERAL: "bilateral.cu", GATHER: "gather.cu",
           GATHER_ONEHOT: "gather.cu"}

# Launches per kernel since the last reset_launch_counts().
launch_counts: Dict[str, int] = {name: 0 for name in SOURCES}

# Seconds spent in nvcc by this process, per source (0 when the library
# was cached), and what ptxas said about each kernel's registers, shared
# memory and spills.
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_source_locks = {source: threading.Lock() for source in set(SOURCES.values())}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of badslam_torch "
        "are built from source at first use")


def _library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the shared library of one .cu source."""
    with _source_locks[source]:
        if source in _libs:
            return _libs[source]
        src_path = os.path.join(_CSRC_DIR, source)
        with open(src_path, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        stem = os.path.splitext(source)[0]
        lib_path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp_path, src_path],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src_path}:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp_path, lib_path)
                build_logs[source] = proc.stderr
            finally:
                if os.path.exists(tmp_path):
                    os.remove(tmp_path)
            build_seconds[source] = time.perf_counter() - t0
        else:
            build_seconds.setdefault(source, 0.0)
        lib = ctypes.CDLL(lib_path)
        _libs[source] = lib
        return lib


def _bilateral_fn():
    fn = _library("bilateral.cu").badslam_bilateral_filter_and_cutoff
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Build and load every kernel library now (otherwise done at first
    use): one nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    sources = sorted(set(SOURCES.values()))
    with ThreadPoolExecutor(len(sources)) as pool:
        for future in [pool.submit(_library, s) for s in sources]:
            future.result()


# Largest radius whose tile + halo fits the default 48 KB of shared memory
# with room to spare: (32 + 2r)(8 + 2r) floats.
_MAX_RADIUS = 16


def bilateral_filter_and_cutoff_cuda(
    depth: torch.Tensor,
    max_depth: float,
    sigma_xy: float = 1.5,
    radius_factor: float = 2.0,
    sigma_inv_depth: float = 0.005,
) -> torch.Tensor:
    """Launch K1 on a CUDA [H, W] f32 contiguous depth map; returns a new
    [H, W] f32 tensor. Raises on any other input."""
    if not depth.is_cuda:
        raise ValueError("bilateral_filter_and_cutoff_cuda needs a CUDA tensor")
    if depth.dtype != torch.float32 or depth.ndim != 2:
        raise ValueError(
            f"expected a [H, W] float32 depth map, got {tuple(depth.shape)} "
            f"{depth.dtype}")
    if not depth.is_contiguous():
        raise ValueError("depth map must be contiguous")
    radius = int(radius_factor * sigma_xy + 0.5)
    if not 0 <= radius <= _MAX_RADIUS:
        raise ValueError(f"filter radius {radius} outside [0, {_MAX_RADIUS}]")
    h, w = depth.shape
    out = torch.empty_like(depth)
    if depth.numel() == 0:
        return out
    fn = _bilateral_fn()
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        err = fn(depth.data_ptr(), out.data_ptr(), h, w, radius,
                 float(max_depth), 2.0 * sigma_xy * sigma_xy,
                 2.0 * sigma_inv_depth * sigma_inv_depth, stream)
    if err != 0:
        raise RuntimeError(f"bilateral filter kernel launch failed: CUDA error {err}")
    launch_counts[BILATERAL] += 1
    return out


def bilateral_filter(
    depth: torch.Tensor,
    max_depth: float,
    sigma_xy: float = 1.5,
    radius_factor: float = 2.0,
    sigma_inv_depth: float = 0.005,
) -> torch.Tensor:
    """Bilateral filter + max-depth cutoff on the device of `depth`: the CUDA
    kernel for a CUDA tensor, the plain PyTorch version for a CPU tensor."""
    if depth.is_cuda:
        return bilateral_filter_and_cutoff_cuda(
            depth.contiguous(), max_depth, sigma_xy, radius_factor,
            sigma_inv_depth)
    if depth.device.type != "cpu":
        raise ValueError(f"no bilateral filter for device {depth.device}")
    from badslam_torch.ops.preprocess import bilateral_filter_and_cutoff

    return bilateral_filter_and_cutoff(
        depth, max_depth, sigma_xy, radius_factor, sigma_inv_depth)


def _gather_fn(index_dtype: torch.dtype):
    lib = _library("gather.cu")
    fn = (lib.badslam_gather_i32 if index_dtype == torch.int32
          else lib.badslam_gather_i64)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _gather_onehot_fn():
    fn = _library("gather.cu").badslam_gather_onehot
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_image(img: torch.Tensor, ndim: int, what: str) -> None:
    if not img.is_cuda:
        raise ValueError(f"{what} needs CUDA tensors")
    if img.dtype != torch.float32 or img.ndim != ndim:
        raise ValueError(f"{what}: expected a {ndim}-d float32 image, got "
                         f"{tuple(img.shape)} {img.dtype}")
    if not img.is_contiguous():
        raise ValueError(f"{what}: the image must be contiguous")


def _check_index(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                 dtypes, what: str) -> None:
    for name, idx in (("px", px), ("py", py)):
        if idx.device != img.device:
            raise ValueError(f"{what}: {name} is on {idx.device}, the image "
                             f"on {img.device}")
        if idx.dtype not in dtypes or not idx.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{' or '.join(map(str, dtypes))} tensor, got "
                             f"{idx.dtype}")
    if px.dtype != py.dtype or px.shape != py.shape:
        raise ValueError(f"{what}: px and py differ in dtype or shape")


def gather_cuda(img: torch.Tensor, px: torch.Tensor,
                py: torch.Tensor) -> torch.Tensor:
    """Launch K2: out[b, i] = img[b].flat[py[b, i] * W + px[b, i]], with
    jnp.take's fill semantics (negative flat indices wrap once, anything
    outside [-H*W, H*W) gives NaN). `img` is [B, H, W] float32 and px/py
    [B, N] int32 or int64, all contiguous on one CUDA device; returns a new
    [B, N] float32 tensor. Raises on any other input."""
    _check_image(img, 3, "gather_cuda")
    _check_index(img, px, py, (torch.int32, torch.int64), "gather_cuda")
    b, h, w = img.shape
    if px.ndim != 2 or px.shape[0] != b:
        raise ValueError(f"gather_cuda: indices {tuple(px.shape)} do not "
                         f"match the image batch {b}")
    out = torch.empty(px.shape, dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    fn = _gather_fn(px.dtype)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(),
                 b, px.shape[1], h, w, stream)
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed: CUDA error {err}")
    launch_counts[GATHER] += 1
    return out


def gather_onehot_cuda(img: torch.Tensor, px: torch.Tensor,
                       py: torch.Tensor) -> torch.Tensor:
    """Launch K3 on a CUDA [H, W] float32 image with [H, W] int32 px/py:
    img[py, px] where py lies in the +/-4-row window of the output row's
    8-row block and px in the image, else 0. Returns a new [H, W] float32
    tensor. Raises on any other input."""
    _check_image(img, 2, "gather_onehot_cuda")
    _check_index(img, px, py, (torch.int32,), "gather_onehot_cuda")
    if px.shape != img.shape:
        raise ValueError(f"gather_onehot_cuda: indices {tuple(px.shape)} do "
                         f"not match the image {tuple(img.shape)}")
    h, w = img.shape
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    fn = _gather_onehot_fn()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(),
                 h, w, stream)
    if err != 0:
        raise RuntimeError(
            f"one-hot gather kernel launch failed: CUDA error {err}")
    launch_counts[GATHER_ONEHOT] += 1
    return out
