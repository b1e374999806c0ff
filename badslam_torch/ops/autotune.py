"""Persisted kernel autotuning (the reference's CUDAAutoTuner).

The reference tunes its CUDA kernels' block sizes once per machine and
persists the results (libvis/src/libvis/cuda/cuda_auto_tuner.h:44-204,
applications/badslam/scripts/auto_tune_parameters.py). The port tunes the
launch shape of its bilateral kernel (K1's tile,
``ops.kernels.autotune_bilateral_tile``); this module is the generic part:

* ``autotune(key, variants, iterations=ITERATIONS)`` warms each
  no-argument variant once, times it over `iterations` calls, skips (and names) the variants
  that raise, and persists and returns the fastest one's name (None when
  every variant raised). The time is the card's on a CUDA device (see
  ``autotune``), the host clock on the CPU.
* The store: ``get``/``put`` on a JSON file at ``_TUNING_PATH``
  (``~/.cache/badslam_torch/auto_tuning_result.json``, the reference's
  auto_tuning_result.txt), read once per process and path and cached;
  ``put`` updates the cache and writes the file, so a kernel launch that
  looks up its tuned shape never reads the file. ``generation`` counts the
  puts, so a caller may cache what it looked up per path and generation. Delete the file to forget every tuned value.
* Keys are scoped by the device (``device_key``): the card's name, so a
  store tuned on another card model is never read, or ``cpu``.
* Both entry points target the card unless the caller asks for the CPU
  (``device="cpu"``), and raise RuntimeError where CUDA is missing, as
  every entry point of the port does.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Optional

import torch

_log = logging.getLogger(__name__)

_TUNING_PATH = os.path.expanduser(
    "~/.cache/badslam_torch/auto_tuning_result.json")

# The store's contents per file path, each read once (see _load).
_cache: Dict[str, dict] = {}
# One more for each put.
generation = 0
# Timed calls per variant unless the caller asks for another number.
ITERATIONS = 10
# Milliseconds per call of each variant that the last `autotune` timed.
last_times: Dict[str, float] = {}

# Cycles the card spins before the timed calls (~2 ms at an H100's
# clocks): long enough for the host to enqueue them all, so the events
# time the card's back-to-back work and not the host's launches.
_HOLD_CYCLES = 4_000_000


def _load() -> dict:
    path = _TUNING_PATH
    if path not in _cache:
        try:
            with open(path) as f:
                _cache[path] = json.load(f)
        except FileNotFoundError:
            _cache[path] = {}
        except ValueError as e:
            raise ValueError(f"{path} is not a tuning store (delete it to "
                             f"start afresh): {e}") from e
    return _cache[path]


def get(key: str, default=None):
    return _load().get(key, default)


def put(key: str, value) -> None:
    global generation
    d = _load()
    generation += 1
    d[key] = value
    os.makedirs(os.path.dirname(_TUNING_PATH) or ".", exist_ok=True)
    with open(_TUNING_PATH, "w") as f:
        json.dump(d, f, indent=2, sort_keys=True)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available "
                           f"(pass device='cpu' to tune on the CPU)")
    return device


def device_key(key: str, device="cuda") -> str:
    """Scope a tuning key by the device: the card's name for a CUDA
    device (as torch.cuda.get_device_name gives it), ``cpu`` for the CPU."""
    device = _device(device)
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)}:{key}"
    if device.type != "cpu":
        raise ValueError(f"no tuning scope for device {device}")
    return f"cpu:{key}"


def _time_ms(thunk, iterations: int, device: torch.device) -> float:
    """Milliseconds per call of `iterations` calls of `thunk`, after one
    warm-up call."""
    if device.type != "cuda":
        thunk()
        t0 = time.perf_counter()
        for _ in range(iterations):
            thunk()
        return 1e3 * (time.perf_counter() - t0) / iterations
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        thunk()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_HOLD_CYCLES)
        start.record(stream)
        for _ in range(iterations):
            thunk()
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / iterations


def autotune(
    key: str,
    variants: Dict[str, Callable[[], object]],
    iterations: int = ITERATIONS,
    device="cuda",
) -> Optional[str]:
    """Time each no-argument variant thunk on `device`, persist the
    fastest one's name under ``device_key(key, device)`` and return it;
    None when every variant raised. Each variant is called once to warm
    up, then `iterations` times under the clock. On a CUDA device the
    clock is a pair of CUDA events on the current stream, ended by one
    synchronization on the end event; a spin kernel holds the stream back
    while the calls are enqueued, so the pair times the card's work. On
    the CPU it is the host clock. A variant that raises is skipped and
    named on one log line."""
    device = _device(device)
    last_times.clear()
    best_name: Optional[str] = None
    best_ms = float("inf")
    for name, thunk in variants.items():
        try:
            ms = _time_ms(thunk, iterations, device)
        except Exception as e:  # a variant that does not run is no candidate
            _log.warning("autotune %s: skipping variant %s: %s: %s", key, name,
                         type(e).__name__, e)
            continue
        last_times[name] = ms
        if ms < best_ms:
            best_name, best_ms = name, ms
    if best_name is not None:
        put(device_key(key, device), best_name)
    return best_name
