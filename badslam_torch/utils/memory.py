"""Device memory introspection.

Counterpart of ``badslam_tpu/utils/memory.py`` (the reference's
cudaMemGetInfo gate of the memory-pressure keyframe merge,
bad_slam.cc:962-972, and its PrintGPUMemoryUsage line), on
``torch.cuda.mem_get_info`` and the caching allocator's counters. These
are host-side queries, not reads of device data. On the CPU there are no
stats: the functions return None, and the line says so, as the JAX
package's do when its backend reports none.
"""

from __future__ import annotations

from typing import Optional

import torch


def _cuda_device(device) -> Optional[torch.device]:
    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    return device if device.type == "cuda" else None


def device_memory_stats(device=None) -> Optional[dict]:
    """{bytes_in_use, bytes_limit, bytes_free, peak_bytes_in_use} of a CUDA
    device (default: the current one), or None without one."""
    dev = _cuda_device(device)
    if dev is None:
        return None
    free, total = torch.cuda.mem_get_info(dev)
    return {"bytes_in_use": torch.cuda.memory_allocated(dev),
            "bytes_limit": total,
            "bytes_free": free,
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev)}


def free_device_memory_mb(device=None) -> Optional[float]:
    """Free device memory in MiB as cudaMemGetInfo reports it (other
    processes' allocations included), or None without a CUDA device."""
    stats = device_memory_stats(device)
    if not stats:
        return None
    return stats["bytes_free"] / (1024.0 * 1024.0)


def format_memory_usage(device=None) -> str:
    """PrintGPUMemoryUsage-style one-liner."""
    stats = device_memory_stats(device)
    if not stats:
        return "device memory stats unavailable"
    mb = 1024.0 * 1024.0
    in_use = stats["bytes_in_use"] / mb
    limit = stats["bytes_limit"] / mb
    peak = stats["peak_bytes_in_use"] / mb
    return (f"device memory: {in_use:.1f} MiB in use"
            + (f" / {limit:.1f} MiB" if limit else "")
            + (f" (peak {peak:.1f} MiB)" if peak else ""))
