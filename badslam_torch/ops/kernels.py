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
* H2, keyframe BA's pose Gauss-Newton accumulation (``csrc/pose_coeffs.cu``),
  replaces no TPU kernel: it is ``ba.pose_opt.surfel_pose_coeffs`` on a
  CUDA tensor, in place of the plain chain (``surfel_pose_coeffs_plain``).
* H1, the tracker's Gauss-Newton step (``csrc/track_coeffs.cu``), replaces
  no TPU kernel: on a CUDA tensor it is ``tracking.pairwise``'s
  ``accumulate_pose_coeffs``, ``compute_cost_and_count``, one Gauss-Newton
  step and the duel, in place of their plain chains (``*_plain``).
* H3, keyframe BA's geometry pass (``csrc/geometry_coeffs.cu``), replaces
  no TPU kernel: on a CUDA tensor it is ``ba.geometry_opt``'s per-block
  accumulations and per-row finishes of activation and normals
  (``geometry_normals``) and of positions and descriptors
  (``geometry_position``), in place of their plain chains (``*_plain``).

* Build: at first use, ``nvcc`` compiles the source in this checkout into a
  shared library with a plain C interface under ``badslam_torch/_build/``
  (listed in ``.gitignore``). The library name carries a hash of the
  source, the headers it includes from ``csrc/`` and the flags
  (``_digest``), so an edited source or header is rebuilt. Nothing is
  compiled or loaded when this module is imported.
* Binding: ``ctypes``, with ``c_void_p`` for device pointers and the CUDA
  stream (PyTorch's current stream).
* Dispatch (``bilateral_filter`` here, ``gather_nearest`` and
  ``gather_onehot`` in ``ops.interp``): a CPU tensor goes to the plain
  PyTorch version; a CUDA tensor goes to the kernel, which raises on
  anything it does not take. There is no fallback from a CUDA tensor to the
  plain version.
* K1's tile: the kernel is built for two tile shapes (``bilateral_tiles``,
  read from the library; the first is the default). A launch takes the
  tile that ``--autotune`` stored for the card and image size
  (``autotune_bilateral_tile``, persisted by ``ops.autotune``), else the
  default; a stored tile that the library does not have raises.
* Counts: ``launch_counts[name]`` goes up by one for each launch of that
  kernel, and nowhere else, so a run can show that it went through it;
  ``launch_shapes[name]`` counts the launches per image shape (for K1, per
  ``(H, W, tile)``) and
  ``launch_tags[name]`` per tag: the shard whose work launched it on a
  multi-device mesh (``launch_tag``, set by ``parallel.mesh.on_shard``),
  else None.
* Counts under CUDA-graph replay (``steady.SteadyFrameGraph``): a wrapper
  runs once at capture, not at each replay. The capture records its
  launches with ``count_into`` instead: those outside the graph's IF bodies
  are added once per replay (``add_launches``, on the host), and those of
  one body are added per body that ran, from a device counter the bodies
  bump (``count_on_device``), read once by ``flush_launch_counts`` after a
  run (``frontend.BadSlam.run`` and ``run_live`` call it;
  ``reset_launch_counts`` calls it first), together with the device stamps'
  tables (``utils.timing``). So the counts stay exact with no host read per
  frame.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
import weakref
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from badslam_torch.ops import autotune as tuner
from badslam_torch.ops import robust

_log = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of one source on top of NVCC_FLAGS: H1-H3 round every operation as
# the plain version's PyTorch operations do (no contraction into fused
# multiply-adds but where PyTorch's kernel fuses), so their association
# gates are the plain version's.
SOURCE_FLAGS = {"pose_coeffs.cu": ("-fmad=false",), "track_coeffs.cu": ("-fmad=false",),
                "geometry_coeffs.cu": ("-fmad=false",)}

BILATERAL = "bilateral_filter_and_cutoff"
GATHER = "gather"
GATHER_ONEHOT = "gather_onehot"
POSE_COEFFS = "pose_coeffs"
TRACK_COEFFS = "track_coeffs"
GEOMETRY_NORMALS = "geometry_normals"
GEOMETRY_POSITION = "geometry_position"

# The CUDA source of each kernel, under csrc/.
SOURCES = {BILATERAL: "bilateral.cu", GATHER: "gather.cu",
           GATHER_ONEHOT: "gather.cu", POSE_COEFFS: "pose_coeffs.cu",
           TRACK_COEFFS: "track_coeffs.cu", GEOMETRY_NORMALS: "geometry_coeffs.cu",
           GEOMETRY_POSITION: "geometry_coeffs.cu"}
# Every source built into a library: the kernels' and the CUDA-graph IF
# nodes' (ops/conditional.py).
LIBRARY_SOURCES = sorted(set(SOURCES.values()) | {"conditional.cu"})

# Launches per kernel since the last reset_launch_counts().
launch_counts: Dict[str, int] = {name: 0 for name in SOURCES}
# The same launches, per image shape ((H, W, tile) for K1, (B, H, W) for
# K2, (H, W) for K3, (C, H, W) for H2, (H, W) of the level for H1, (C, H,
# W) of a block and (N,) of a finish for H3).
launch_shapes: Dict[str, Counter] = {name: Counter() for name in SOURCES}
# The same launches, per tag (the launching thread's launch_tag).
launch_tags: Dict[str, Counter] = {name: Counter() for name in SOURCES}
_tag = threading.local()

# Seconds spent in nvcc by this process, per source (0 when the library
# was cached), and what ptxas said about each kernel's registers, shared
# memory and spills.
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_source_locks = {source: threading.Lock() for source in LIBRARY_SOURCES}


def reset_launch_counts() -> None:
    flush_launch_counts()
    for name in launch_counts:
        launch_counts[name] = 0
        launch_shapes[name].clear()
        launch_tags[name].clear()


@contextlib.contextmanager
def launch_tag(tag):
    """Count this thread's launches under `tag` while in the block."""
    old = getattr(_tag, "value", None)
    _tag.value = tag
    try:
        yield
    finally:
        _tag.value = old


def _add(name: str, shape, tag, n: int) -> None:
    launch_counts[name] += n
    launch_shapes[name][shape] += n
    launch_tags[name][tag] += n


def _count(name: str, shape) -> None:
    tag = getattr(_tag, "value", None)
    into = getattr(_recording, "counter", None)
    if into is not None:
        into[(name, shape, tag)] += 1
    else:
        _add(name, shape, tag, 1)


_recording = threading.local()


@contextlib.contextmanager
def count_into(counter: Counter):
    """While in the block, this thread's launches go into `counter`, keyed
    (name, shape, tag), instead of into the counts: what one replay of the
    graph being captured launches."""
    old = getattr(_recording, "counter", None)
    _recording.counter = counter
    try:
        yield
    finally:
        _recording.counter = old


def add_launches(recorded: Counter, times: int = 1) -> None:
    """Add `times` times the launches of `recorded` (from count_into)."""
    for (name, shape, tag), n in recorded.items():
        _add(name, shape, tag, n * times)


# Launches counted on the device: [owner (weak), int32 counter tensor, the
# recorded launches of one unit per counter entry, units already added].
_on_device: List[list] = []


def count_on_device(owner, counter: torch.Tensor, per_unit: List[Counter]) -> None:
    """Count `per_unit[i]` once for each unit that `counter[i]` (a device
    int tensor that the graph bumps, starting at 0) holds, at the next
    flush_launch_counts; `owner` (the graph) is held weakly."""
    _on_device.append([weakref.ref(owner), counter, per_unit, [0] * len(per_unit)])


def _read_together(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """The values of integer tensors on the host, as int64 arrays: those on
    one device copied in one read (one device sync per device)."""
    out: List[Optional[np.ndarray]] = [None] * len(tensors)
    by_device: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        by_device.setdefault(t.device, []).append(i)
    for idx in by_device.values():
        flat = torch.cat([tensors[i].reshape(-1).to(torch.int64) for i in idx]).cpu().numpy()
        for i, part in zip(idx, np.split(flat, np.cumsum([tensors[i].numel() for i in idx])[:-1])):
            out[i] = part
    return out


def flush_launch_counts() -> None:
    """Add the launches counted on the device since the last flush and fold
    the device stamps into their timers (``utils.timing``): the registered
    counters and the stamp tables of a device read together (one device
    sync per device). Entries whose owner is gone are dropped once flushed.
    Then each stamp table reads its clock again where the card is idle."""
    from badslam_torch.utils.timing import Timing

    tables = Timing.stamp_tables()
    values = _read_together([entry[1] for entry in _on_device] + [t.tensor for t in tables])
    keep = []
    for entry, units in zip(_on_device, values):
        owner, counter, per_unit, added = entry
        units = units.tolist()
        for i, recorded in enumerate(per_unit):
            add_launches(recorded, units[i] - added[i])
            added[i] = units[i]
        if owner() is not None:
            keep.append(entry)
    _on_device[:] = keep
    Timing.fold_tables(dict(zip(tables, values[len(values) - len(tables):])))
    for table in tables:
        table.recalibrate()


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


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def _sources_hashed(source: str) -> List[str]:
    """The source and every header under csrc/ that it includes with
    ``#include "..."`` (and those include), in the order _digest hashes
    them."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen or not os.path.isfile(os.path.join(_CSRC_DIR, name)):
            continue
        seen.append(name)
        with open(os.path.join(_CSRC_DIR, name), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return seen


def _digest(source: str) -> str:
    """The hash in a library's name: of the files _sources_hashed names and
    of the source's flags, so that an edit to any of them builds the
    library anew."""
    h = hashlib.sha256()
    for name in _sources_hashed(source):
        with open(os.path.join(_CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(source, ())).encode())
    return h.hexdigest()[:16]


def _library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the shared library of one .cu source."""
    with _source_locks[source]:
        if source in _libs:
            return _libs[source]
        src_path = os.path.join(_CSRC_DIR, source)
        flags = NVCC_FLAGS + SOURCE_FLAGS.get(source, ())
        stem = os.path.splitext(source)[0]
        lib_path = os.path.join(BUILD_DIR, f"lib{stem}_{_digest(source)}.so")
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [_nvcc(), *flags, "-o", tmp_path, src_path],
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
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


Tile = Tuple[int, int]
_tiles: List[Tile] = []


def bilateral_tiles() -> List[Tile]:
    """K1's tile shapes as the library was built with them: (threads
    down, outputs per thread) per tile; the first is the default."""
    if not _tiles:
        fn = _library("bilateral.cu").badslam_bilateral_tiles
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        n = fn(None)
        table = (ctypes.c_int * (2 * n))()
        fn(table)
        _tiles[:] = [(table[2 * i], table[2 * i + 1]) for i in range(n)]
    return list(_tiles)


def tile_name(tile: Tile) -> str:
    """A tile's name in the tuning store: "<threads down>x<outputs per
    thread>", e.g. "8x2"."""
    return f"{tile[0]}x{tile[1]}"


def stored_bilateral_tile(key: str, tiles: List[Tile]) -> Optional[Tile]:
    """The tile stored under `key` in the tuning store, None when there is
    none; raises ValueError, naming the store file, when the stored tile is
    not in `tiles`."""
    name = tuner.get(key)
    if name is None:
        return None
    for tile in tiles:
        if tile_name(tile) == name:
            return tile
    raise ValueError(
        f"{tuner._TUNING_PATH}: {key} holds the tile {name!r}, which the "
        f"bilateral kernel is not built for (its tiles: "
        f"{', '.join(map(tile_name, tiles))}); delete the entry or the file "
        f"and tune again")


# The tile a default launch takes, (library index, tile), per (store file,
# store generation, device index, H, W): the store is looked up once per
# card and size, and again only after it changed (tuner.generation).
_tuned: Dict[tuple, Tuple[int, Tile]] = {}


def _tile_index(tile: Optional[Tile], device: torch.device, h: int,
                w: int) -> Tuple[int, Tile]:
    """The library's index of `tile`, or of the tile tuned for this card
    and image size (else the default) when `tile` is None."""
    if tile is None:
        at = (tuner._TUNING_PATH, tuner.generation, device.index, h, w)
        if at not in _tuned:
            tiles = bilateral_tiles()
            key = tuner.device_key(f"bilateral_{h}x{w}", device)
            tile = stored_bilateral_tile(key, tiles) or tiles[0]
            _tuned[at] = (tiles.index(tile), tile)
        return _tuned[at]
    tiles = bilateral_tiles()
    tile = tuple(tile)
    if tile not in tiles:
        raise ValueError(f"the bilateral kernel has no tile {tile}; its tiles: "
                         f"{tiles}")
    return tiles.index(tile), tile


def bilateral_launch_info(height: int, width: int, radius: int,
                          tile: Optional[Tile] = None) -> Dict[str, int]:
    """How K1's launch at this shape and radius fills the current card: its
    grid, block, shared memory, registers and local (spill) bytes per
    thread, blocks resident per SM, the card's SM count and the threads an
    SM holds at most. `tile`: as in bilateral_filter_and_cutoff_cuda."""
    index, _ = _tile_index(tile, torch.device("cuda", torch.cuda.current_device()),
                           height, width)
    fn = _library("bilateral.cu").badslam_bilateral_launch_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 9)()
    err = fn(height, width, radius, index, info)
    if err != 0:
        raise RuntimeError(f"bilateral launch info failed: CUDA error {err}")
    keys = ("grid_x", "grid_y", "threads", "shared_bytes", "registers",
            "local_bytes", "blocks_per_sm", "sms", "sm_threads")
    return dict(zip(keys, info))


def build() -> None:
    """Build and load every kernel library now (otherwise done at first
    use): one nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(LIBRARY_SOURCES)) as pool:
        for future in [pool.submit(_library, s) for s in LIBRARY_SOURCES]:
            future.result()


# Largest radius the kernel takes; the taller tile + halo, (32 + 2 * 16) x
# (16 + 2 * 16) floats, is 12 KB of the default 48 KB of shared memory.
_MAX_RADIUS = 16


def bilateral_filter_and_cutoff_cuda(
    depth: torch.Tensor,
    max_depth: float,
    sigma_xy: float = 1.5,
    radius_factor: float = 2.0,
    sigma_inv_depth: float = 0.005,
    tile: Optional[Tile] = None,
) -> torch.Tensor:
    """Launch K1 on a CUDA [H, W] f32 contiguous depth map; returns a new
    [H, W] f32 tensor. Raises on any other input. `tile` (threads down,
    outputs per thread) is one of bilateral_tiles(); None takes the tile
    stored for this card and image size by autotune_bilateral_tile, else
    the default. Every tile gives the same bits."""
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
    index, tile = _tile_index(tile, depth.device, h, w)
    out = torch.empty_like(depth)
    if depth.numel() == 0:
        return out
    fn = _bilateral_fn()
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        err = fn(depth.data_ptr(), out.data_ptr(), h, w, radius,
                 float(max_depth), 2.0 * sigma_xy * sigma_xy,
                 2.0 * sigma_inv_depth * sigma_inv_depth, index, stream)
    if err != 0:
        raise RuntimeError(f"bilateral filter kernel launch failed: CUDA error {err}")
    _count(BILATERAL, (h, w, tile))
    return out


def autotune_bilateral_tile(h: int, w: int, max_depth: float = 20.0,
                            device="cuda") -> Tile:
    """Time K1 with each of its tiles on an [h, w] depth map on the card
    (seeded, uniform in [0.5, 3.0] m), persist the fastest under
    "bilateral_{h}x{w}" for this card and return it (the counterpart of
    badslam_tpu's autotune_block_height). A tile that does not launch is
    skipped and named; raises RuntimeError when none launches, since the
    default kernel is then broken."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"autotune_bilateral_tile tunes a CUDA kernel; got "
                         f"device {device}")
    depth = torch.from_numpy(
        np.random.default_rng(0).uniform(0.5, 3.0, (h, w)).astype(np.float32)
    ).to(device)
    tiles = bilateral_tiles()
    best = tuner.autotune(
        f"bilateral_{h}x{w}",
        {tile_name(t): (lambda t=t: bilateral_filter_and_cutoff_cuda(
            depth, max_depth, tile=t)) for t in tiles},
        device=device)
    if best is None:
        raise RuntimeError(f"autotune: no tile of the bilateral kernel launched "
                           f"at {h}x{w} on {device}")
    return next(t for t in tiles if tile_name(t) == best)


def autotune_preprocess(h: int, w: int, max_depth: float = 20.0,
                        device="cuda") -> Optional[Tile]:
    """Tune the preprocessing kernels for one image shape on `device`:
    K1's tile on a card (returned). On the CPU there is no kernel to tune:
    it logs so and returns None, writing nothing. The JAX package also
    picks between its kernel and the XLA version here; the port does not,
    since a card always runs the kernel."""
    device = torch.device(device)
    if device.type == "cpu":
        _log.warning("--autotune: nothing to tune on the CPU (it runs the plain "
                     "PyTorch versions of the kernels); the store is left as it is")
        return None
    return autotune_bilateral_tile(h, w, max_depth=max_depth, device=device)


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
    _count(GATHER, (b, h, w))
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
    _count(GATHER_ONEHOT, (h, w))
    return out


def _check_tensors(what: str, named) -> None:
    """Check a hand kernel's tensors before anything is loaded: each
    (name, tensor, dtype, shape) of `named` has that dtype and shape, the
    first is on a CUDA device, and all are on its device and contiguous."""
    for name, x, dtype, shape in named:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} must be {dtype} {list(shape)}, got "
                             f"{x.dtype} {list(x.shape)}")
    first, ref = named[0][:2]
    if not ref.is_cuda:
        raise ValueError(f"{what} needs CUDA tensors")
    for name, x, _, _ in named:
        if x.device != ref.device:
            raise ValueError(f"{what}: {name} is on {x.device}, {first} on {ref.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _pose_coeffs_fns():
    lib = _library("pose_coeffs.cu")
    tiles = lib.badslam_pose_coeffs_tiles
    tiles.argtypes = [ctypes.c_int64]
    tiles.restype = ctypes.c_int
    fn = lib.badslam_pose_coeffs
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return tiles, fn


def _surfel_constants(cam, baseline_fx: float):
    """H2's and H3's scalar table (csrc/association.cuh's Constants): each
    the float32 that the plain version's PyTorch operation takes, a division
    by a Python scalar on the card being a product with its float32
    inverse."""
    f32 = np.float32
    values = (cam.fx, cam.fy, cam.cx, cam.cy, cam.fx_inv, cam.fy_inv, cam.cx_inv,
              cam.cy_inv, f32(1.0) / f32(baseline_fx),
              robust.DEPTH_UNCERTAINTY_EMPIRICAL_FACTOR, robust.DEPTH_TUKEY_PARAM,
              f32(1.0) / f32(robust.DEPTH_TUKEY_PARAM),
              robust.COS_NORMAL_COMPATIBILITY_THRESHOLD,
              robust.DESCRIPTOR_RESIDUAL_WEIGHT, robust.DESCRIPTOR_HUBER_PARAM)
    return (ctypes.c_float * len(values))(*(float(f32(v)) for v in values))


def pose_coeffs_cuda(pos, normal, radius2, desc, valid, rot, trans, depth, f_nx,
                     f_ny, intensity, cam, baseline_fx: float, use_depth: bool,
                     use_descriptor: bool, running: Optional[torch.Tensor] = None):
    """Launch H2: keyframe BA's pose Gauss-Newton sums of the surfel rows
    (pos, normal [N, 3], radius2 [N], desc [N, 2] float32, valid [N] bool)
    against C keyframes (frame_T_global rotations rot [C, 3, 3] and
    translations trans [C, 3]; planes depth, f_nx, f_ny, intensity [C, H,
    W] float32), or one keyframe without the batch axis ([3, 3], [3], [H,
    W]). `running` ([C] bool, or None for all): a keyframe outside it gets
    zeros. All contiguous on one CUDA device. Returns (H [C, 6, 6], b [C,
    6], count [C] int64), without the batch axis for one keyframe: the
    values of ba.pose_opt.surfel_pose_coeffs_plain, summed in another
    order, the same bits on every launch. Raises on any other input."""
    what = "pose_coeffs_cuda"
    single = rot.ndim == 2
    c = 1 if single else rot.shape[0]
    batch = () if single else (c,)
    n = pos.shape[0]
    h, w = depth.shape[-2:]
    f32 = torch.float32
    named = [("pos", pos, f32, (n, 3)), ("normal", normal, f32, (n, 3)),
             ("radius2", radius2, f32, (n,)), ("desc", desc, f32, (n, 2)),
             ("rot", rot, f32, batch + (3, 3)), ("trans", trans, f32, batch + (3,))]
    named += [(name, plane, f32, batch + (h, w)) for name, plane in
              (("depth", depth), ("f_nx", f_nx), ("f_ny", f_ny), ("intensity", intensity))]
    named.append(("valid", valid, torch.bool, (n,)))
    if running is not None:
        named.append(("running", running, torch.bool, batch))
    _check_tensors(what, named)
    device = pos.device
    if not 0 < c <= 65535:
        raise ValueError(f"{what}: {c} keyframes; the kernel takes 1 to 65535")
    tiles_fn, fn = _pose_coeffs_fns()
    tiles = tiles_fn(n)
    partial = torch.empty((c, tiles, 28), dtype=torch.float32, device=device)
    H = torch.empty((c, 6, 6), dtype=torch.float32, device=device)
    b = torch.empty((c, 6), dtype=torch.float32, device=device)
    count = torch.empty((c,), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(pos.data_ptr(), normal.data_ptr(), radius2.data_ptr(), desc.data_ptr(),
                 valid.data_ptr(), n, rot.data_ptr(), trans.data_ptr(),
                 None if running is None else running.data_ptr(), c, depth.data_ptr(),
                 f_nx.data_ptr(), f_ny.data_ptr(), intensity.data_ptr(), h, w,
                 _surfel_constants(cam, baseline_fx), int(use_depth),
                 int(use_descriptor), partial.data_ptr(), H.data_ptr(), b.data_ptr(),
                 count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pose coefficients kernel launch failed: CUDA error {err}")
    _count(POSE_COEFFS, (c, h, w))
    if single:
        return H[0], b[0], count[0]
    return H, b, count


def _geometry_fns():
    lib = _library("geometry_coeffs.cu")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    consts = ctypes.POINTER(ctypes.c_float)
    sig = {
        "badslam_geometry_max_slots": [],
        "badslam_geometry_normals": [ptr] * 4 + [i64] + [ptr] * 4 + [i32] + [ptr] * 3
        + [i32] * 2 + [consts] + [ptr] * 4,
        "badslam_geometry_normals_finish": [ptr] * 5 + [i64] + [ptr] * 2,
        "badslam_geometry_position": [ptr] * 6 + [i64] + [ptr] * 3 + [i32] + [ptr] * 4
        + [i32] * 2 + [consts] + [i32] * 2 + [ptr] * 2,
        "badslam_geometry_position_finish": [ptr] * 5 + [i64] + [ptr] + [i32] + [ptr] * 3,
    }
    fns = {}
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name[len("badslam_geometry_"):]] = fn
    return fns


def _geometry_block(what, rows, q, t, planes, masks):
    """Check one H3 launch's tensors before anything is loaded: `rows` and
    the planes as (name, tensor, dtype, shape), q [C, 4] and t [C, 3]
    float32, planes [C, H, W] float32 and masks [C] bool (None skipped).
    Returns (C, H, W)."""
    c = q.shape[0] if q.ndim == 2 else 0
    h, w = planes[0][1].shape[-2:]
    f32 = torch.float32
    named = list(rows) + [("q", q, f32, (c, 4)), ("t", t, f32, (c, 3))]
    named += [(name, x, f32, (c, h, w)) for name, x in planes]
    named += [(name, m, torch.bool, (c,)) for name, m in masks if m is not None]
    _check_tensors(what, named)
    most = _geometry_fns()["max_slots"]()
    if not 0 < c <= most:
        raise ValueError(f"{what}: {c} keyframes; the kernel takes 1 to {most} a launch")
    return c, h, w


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def geometry_normals_cuda(pos, normal, valid, active, q, t, depth, f_nx, f_ny, cam,
                          baseline_fx: float, carry, act_mask=None,
                          normal_mask=None) -> None:
    """Launch H3's activation-and-normals accumulation over one block of C
    keyframes (C at most KEYFRAME_BATCH): the surfel rows (pos, normal [N,
    3] float32, valid, active [N] bool) against the keyframes
    global_T_frame (q [C, 4], t [C, 3]) with their planes (depth, f_nx,
    f_ny [C, H, W] float32). `carry` = (act [N] bool, nsum [N, 3] float32,
    count [N] int64), each None where not summed, as
    ba.geometry_opt._act_normals_init makes it, added into in place: with
    `act_mask` ([C] bool) the rows are the valid ones and a row associated
    with a keyframe of act_mask becomes active; without it the rows are the
    valid and active ones. With nsum the measured normals (rotated to
    world) of the keyframes of `normal_mask` ([C] bool, None for all) are
    summed and counted. All contiguous on one CUDA device; the values of
    _act_normals_chunk_plain / _normals_chunk_plain, a row's keyframes
    summed in slot order, the same bits on every launch. Raises on any
    other input."""
    what = "geometry_normals_cuda"
    act, nsum, count = carry
    n = pos.shape[0]
    f32, i64, b = torch.float32, torch.int64, torch.bool
    rows = [("pos", pos, f32, (n, 3)), ("normal", normal, f32, (n, 3)),
            ("valid", valid, b, (n,)), ("active", active, b, (n,))]
    if (act_mask is None) != (act is None):
        raise ValueError(f"{what}: act_mask and the carry's act go together")
    if act_mask is None and nsum is None:
        raise ValueError(f"{what}: neither activation nor normals to compute")
    if (nsum is None) != (count is None):
        raise ValueError(f"{what}: the carry's nsum and count go together")
    for name, x, dtype, shape in (("act", act, b, (n,)), ("nsum", nsum, f32, (n, 3)),
                                  ("count", count, i64, (n,))):
        if x is not None:
            rows.append((name, x, dtype, shape))
    c, h, w = _geometry_block(what, rows, q, t, [("depth", depth), ("f_nx", f_nx),
                                                 ("f_ny", f_ny)],
                              [("act_mask", act_mask), ("normal_mask", normal_mask)])
    fn = _geometry_fns()["normals"]
    with torch.cuda.device(pos.device):
        err = fn(pos.data_ptr(), normal.data_ptr(), valid.data_ptr(), active.data_ptr(), n,
                 q.data_ptr(), t.data_ptr(), _ptr(act_mask), _ptr(normal_mask), c,
                 depth.data_ptr(), f_nx.data_ptr(), f_ny.data_ptr(), h, w,
                 _surfel_constants(cam, baseline_fx), _ptr(act), _ptr(nsum), _ptr(count),
                 _stream(pos))
    if err != 0:
        raise RuntimeError(f"geometry normals kernel launch failed: CUDA error {err}")
    _count(GEOMETRY_NORMALS, (c, h, w))


def geometry_normals_finish_cuda(normal, valid, active, carry) -> torch.Tensor:
    """Launch H3's normal finish (_renormalized) on a carry of
    geometry_normals_cuda: the averaged, re-normalized normals of the rows
    the carry's act marks (with activation) or of the valid and active rows
    (without: carry[0] None), the others' as `normal`. Returns a new [N, 3]
    float32 tensor. Raises on what it does not take."""
    what = "geometry_normals_finish_cuda"
    act, nsum, count = carry
    n = normal.shape[0]
    f32, b = torch.float32, torch.bool
    named = [("normal", normal, f32, (n, 3)), ("valid", valid, b, (n,)),
             ("active", active, b, (n,)), ("nsum", nsum, f32, (n, 3)),
             ("count", count, torch.int64, (n,))]
    if act is not None:
        named.append(("act", act, b, (n,)))
    _check_tensors(what, named)
    out = normal.clone()
    fn = _geometry_fns()["normals_finish"]
    with torch.cuda.device(normal.device):
        err = fn(valid.data_ptr(), active.data_ptr(), _ptr(act), nsum.data_ptr(),
                 count.data_ptr(), n, out.data_ptr(), _stream(normal))
    if err != 0:
        raise RuntimeError(f"geometry normals finish launch failed: CUDA error {err}")
    _count(GEOMETRY_NORMALS, (n,))
    return out


def geometry_position_sums(n: int, use_descriptor: bool, device) -> torch.Tensor:
    """The zeroed carry of geometry_position_cuda for n rows: [8, N] float32
    (H00 H01 H02 H11 H22 b0 b1 b2) with descriptors, else [2, N] (H, b)."""
    return torch.zeros((8 if use_descriptor else 2, n), dtype=torch.float32, device=device)


def geometry_position_cuda(pos, normal, radius2, desc, valid, active, q, t, depth, f_nx,
                           f_ny, intensity, mask, cam, baseline_fx: float, use_depth: bool,
                           use_descriptor: bool, sums) -> None:
    """Launch H3's position accumulation over one block of C keyframes (C
    at most KEYFRAME_BATCH): the valid and active surfel rows (pos, normal
    [N, 3], radius2 [N], desc [N, 2] float32, valid, active [N] bool)
    against the keyframes of `mask` ([C] bool, None for all), global_T_frame
    (q [C, 4], t [C, 3]) with their planes (depth, f_nx, f_ny and, with
    descriptors, intensity [C, H, W] float32). Adds each row's Gauss-Newton
    sums into `sums` (geometry_position_sums) in place: the depth residual
    alone without descriptors (whatever use_depth says, as
    _pos1d_chunk_plain), else the descriptor residuals and, with use_depth,
    the depth residual (_pos3d_chunk_plain). All contiguous on one CUDA
    device; a row's keyframes summed in slot order, the same bits on every
    launch. Raises on any other input."""
    what = "geometry_position_cuda"
    n = pos.shape[0]
    f32, b = torch.float32, torch.bool
    rows = [("pos", pos, f32, (n, 3)), ("normal", normal, f32, (n, 3)),
            ("radius2", radius2, f32, (n,)), ("desc", desc, f32, (n, 2)),
            ("valid", valid, b, (n,)), ("active", active, b, (n,)),
            ("sums", sums, f32, (8 if use_descriptor else 2, n))]
    planes = [("depth", depth), ("f_nx", f_nx), ("f_ny", f_ny)]
    if use_descriptor:
        if intensity is None:
            raise ValueError(f"{what}: the descriptor residuals need the intensity planes")
        planes.append(("intensity", intensity))
    c, h, w = _geometry_block(what, rows, q, t, planes, [("mask", mask)])
    fn = _geometry_fns()["position"]
    with torch.cuda.device(pos.device):
        err = fn(pos.data_ptr(), normal.data_ptr(), radius2.data_ptr(), desc.data_ptr(),
                 valid.data_ptr(), active.data_ptr(), n, q.data_ptr(), t.data_ptr(),
                 _ptr(mask), c, depth.data_ptr(), f_nx.data_ptr(), f_ny.data_ptr(),
                 _ptr(intensity) if use_descriptor else None, h, w,
                 _surfel_constants(cam, baseline_fx), int(use_depth), int(use_descriptor),
                 sums.data_ptr(), _stream(pos))
    if err != 0:
        raise RuntimeError(f"geometry position kernel launch failed: CUDA error {err}")
    _count(GEOMETRY_POSITION, (c, h, w))


def geometry_position_finish_cuda(pos, normal, desc, valid, active, sums,
                                  use_descriptor: bool):
    """Launch H3's position finish (_pos1d_finish / _pos3d_finish) on the
    sums of geometry_position_cuda: the valid and active rows' solved
    steps. Returns new (pos [N, 3], desc [N, 2]) float32 tensors, the other
    rows' as the inputs (desc itself without descriptors). Raises on what
    it does not take."""
    what = "geometry_position_finish_cuda"
    n = pos.shape[0]
    f32, b = torch.float32, torch.bool
    _check_tensors(what, [("pos", pos, f32, (n, 3)), ("normal", normal, f32, (n, 3)),
                          ("desc", desc, f32, (n, 2)), ("valid", valid, b, (n,)),
                          ("active", active, b, (n,)),
                          ("sums", sums, f32, (8 if use_descriptor else 2, n))])
    pos_out = pos.clone()
    desc_out = desc.clone() if use_descriptor else desc
    fn = _geometry_fns()["position_finish"]
    with torch.cuda.device(pos.device):
        err = fn(pos.data_ptr(), normal.data_ptr(), desc.data_ptr(), valid.data_ptr(),
                 active.data_ptr(), n, sums.data_ptr(), int(use_descriptor),
                 pos_out.data_ptr(), desc_out.data_ptr(), _stream(pos))
    if err != 0:
        raise RuntimeError(f"geometry position finish launch failed: CUDA error {err}")
    _count(GEOMETRY_POSITION, (n,))
    return pos_out, desc_out


def _track_fns():
    lib = _library("track_coeffs.cu")
    tiles = lib.badslam_track_tiles
    tiles.argtypes = [ctypes.c_int, ctypes.c_int]
    tiles.restype = ctypes.c_int
    head = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
            + [ctypes.POINTER(ctypes.c_float), ctypes.c_int])
    coeffs = lib.badslam_track_coeffs
    coeffs.argtypes = head + [ctypes.c_void_p] * 7
    step = lib.badslam_track_step
    step.argtypes = (head + [ctypes.c_void_p] * 3 + [ctypes.c_float] * 2
                     + [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p])
    cost = lib.badslam_track_cost
    cost.argtypes = head + [ctypes.c_void_p] * 10
    for fn in (coeffs, step, cost):
        fn.restype = ctypes.c_int
    return tiles, coeffs, step, cost


def _track_constants(cam, threshold_factor: float, baseline_fx: float):
    """H1's scalar table (csrc/track_coeffs.cu's Constants) for one pyramid
    level: each the float32 that the plain version's PyTorch operation
    takes, a division by a Python scalar on the card being a product with
    its float32 inverse."""
    f32 = np.float32
    tukey = float(threshold_factor) * robust.DEPTH_TUKEY_PARAM
    values = (cam.fx, cam.fy, cam.cx, cam.cy, cam.fx_inv, cam.fy_inv, cam.cx_inv,
              cam.cy_inv, f32(1.0) / f32(baseline_fx),
              robust.DEPTH_UNCERTAINTY_EMPIRICAL_FACTOR, tukey, f32(1.0) / f32(tukey),
              tukey * tukey / 6.0, robust.DEPTH_RESIDUAL_WEIGHT,
              robust.COS_NORMAL_COMPATIBILITY_THRESHOLD,
              float(threshold_factor) * robust.DESCRIPTOR_RESIDUAL_WEIGHT,
              robust.DESCRIPTOR_HUBER_PARAM, 0.5 * robust.DESCRIPTOR_HUBER_PARAM)
    return (ctypes.c_float * len(values))(*(float(f32(v)) for v in values))


def _track_inputs(base, tracked, poses, what: str):
    """Check H1's inputs before anything is loaded: two pyramid levels
    (depth, nx, ny, intensity [H, W] float32 each, one shape) and the poses'
    (q [4], t [3]) float32, all contiguous on one CUDA device. Returns (H,
    W)."""
    depth = base[0]
    if depth.ndim != 2:
        raise ValueError(f"{what}: expected [H, W] planes, got {list(depth.shape)}")
    shape = tuple(depth.shape)
    if min(shape) < 1:
        raise ValueError(f"{what}: empty planes {list(shape)}")
    named = [(f"base.{f}", x, torch.float32, shape) for f, x in zip(base._fields, base)]
    named += [(f"tracked.{f}", x, torch.float32, shape)
              for f, x in zip(tracked._fields, tracked)]
    for i, (q, t) in enumerate(poses):
        named += [(f"q{i}", q, torch.float32, (4,)), (f"t{i}", t, torch.float32, (3,))]
    _check_tensors(what, named)
    return shape


def _track_flags(use_depth: bool, use_descriptor: bool, use_gradmag: bool) -> int:
    return int(bool(use_depth)) | int(bool(use_descriptor)) << 1 | int(bool(use_gradmag)) << 2


def _track_launch(fn, base, tracked, h, w, cam, threshold_factor, baseline_fx, flags,
                  *args):
    device = base.depth.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(p.data_ptr() for p in base), *(p.data_ptr() for p in tracked), h, w,
                 _track_constants(cam, threshold_factor, baseline_fx), flags, *args, stream)
    if err != 0:
        raise RuntimeError(f"tracker kernel launch failed: CUDA error {err}")
    _count(TRACK_COEFFS, (h, w))


def track_coeffs_cuda(cam, base, tracked, q, t, threshold_factor: float,
                      baseline_fx: float, use_depth: bool, use_descriptor: bool,
                      use_gradmag: bool):
    """Launch H1's coefficient mode: the tracker's Gauss-Newton sums of the
    base level's pixels (``base``, ``tracked``: pyramid levels of [H, W]
    float32 planes) at base_T_frame (q [4], t [3]). Returns (H [6, 6], b
    [6], count int64): the values of
    tracking.pairwise.accumulate_pose_coeffs_plain, summed in another order,
    the same bits on every launch. Raises on any other input."""
    h, w = _track_inputs(base, tracked, [(q, t)], "track_coeffs_cuda")
    tiles_fn, fn, _, _ = _track_fns()
    device = q.device
    partial = torch.empty((tiles_fn(h, w), 28), dtype=torch.float32, device=device)
    H = torch.empty((6, 6), dtype=torch.float32, device=device)
    b = torch.empty((6,), dtype=torch.float32, device=device)
    count = torch.empty((), dtype=torch.int64, device=device)
    _track_launch(fn, base, tracked, h, w, cam, threshold_factor, baseline_fx,
                  _track_flags(use_depth, use_descriptor, use_gradmag), q.data_ptr(),
                  t.data_ptr(), partial.data_ptr(), H.data_ptr(), b.data_ptr(),
                  count.data_ptr())
    return H, b, count


def track_step_cuda(cam, base, tracked, q, t, threshold_factor: float, damping: float,
                    converge_below: float, baseline_fx: float, use_depth: bool,
                    use_descriptor: bool, use_gradmag: bool, q_out, t_out, converged,
                    iterations=None, flag=None, bound: int = 0) -> None:
    """Launch one tracker Gauss-Newton step on the card (H1's coefficient
    mode, then its one-block step): from base_T_frame (q, t) it writes
    (q_out, t_out), which may be q and t themselves, and the device bool
    `converged` (sum of the guarded step's squares below `converge_below`),
    as tracking.pairwise._gn_step_plain computes them. With `iterations`
    (an int64 scalar) it also adds one to it and writes the bool `flag` =
    not converged and iterations < `bound`: a WHILE body's loop state.
    Raises on any other input."""
    what = "track_step_cuda"
    h, w = _track_inputs(base, tracked, [(q, t), (q_out, t_out)], what)
    state = [("converged", converged, torch.bool)]
    if iterations is not None:
        state += [("iterations", iterations, torch.int64), ("flag", flag, torch.bool)]
    for name, x, dtype in state:
        if not isinstance(x, torch.Tensor) or x.device != q.device or x.dtype != dtype \
                or x.numel() != 1:
            raise ValueError(f"{what}: {name} must be a {dtype} scalar on {q.device}")
    tiles_fn, _, fn, _ = _track_fns()
    partial = torch.empty((tiles_fn(h, w), 28), dtype=torch.float32, device=q.device)
    _track_launch(fn, base, tracked, h, w, cam, threshold_factor, baseline_fx,
                  _track_flags(use_depth, use_descriptor, use_gradmag), q.data_ptr(),
                  t.data_ptr(), partial.data_ptr(), -float(damping), float(converge_below),
                  q_out.data_ptr(), t_out.data_ptr(), converged.data_ptr(),
                  None if iterations is None else iterations.data_ptr(),
                  None if iterations is None else flag.data_ptr(), int(bound))


def track_cost_cuda(cam, base, tracked, poses, threshold_factor: float,
                    baseline_fx: float, use_depth: bool, use_descriptor: bool,
                    use_gradmag: bool):
    """Launch H1's cost mode over one or two poses ([(q, t)] base_T_frame,
    [4] and [3] float32), all in one launch. One pose: returns (cost
    float32, count int64), the values of
    tracking.pairwise.compute_cost_and_count_plain summed in another order.
    Two: returns the duel's choice (q, t) between them (pairwise._duel_plain).
    Raises on any other input."""
    what = "track_cost_cuda"
    if len(poses) not in (1, 2):
        raise ValueError(f"{what}: one or two poses, got {len(poses)}")
    h, w = _track_inputs(base, tracked, poses, what)
    tiles_fn, _, _, fn = _track_fns()
    device = poses[0][0].device
    partial = torch.empty((len(poses), tiles_fn(h, w), 3), dtype=torch.float32,
                          device=device)
    if len(poses) == 1:
        cost = torch.empty((), dtype=torch.float32, device=device)
        count = torch.empty((), dtype=torch.int64, device=device)
        out = (cost.data_ptr(), count.data_ptr(), None, None)
        pose_ptrs = (poses[0][0].data_ptr(), poses[0][1].data_ptr(), None, None)
        result = (cost, count)
    else:
        q = torch.empty((4,), dtype=torch.float32, device=device)
        t = torch.empty((3,), dtype=torch.float32, device=device)
        out = (None, None, q.data_ptr(), t.data_ptr())
        pose_ptrs = tuple(x.data_ptr() for pose in poses for x in pose)
        result = (q, t)
    _track_launch(fn, base, tracked, h, w, cam, threshold_factor, baseline_fx,
                  _track_flags(use_depth, use_descriptor, use_gradmag), *pose_ptrs,
                  partial.data_ptr(), *out)
    return result
