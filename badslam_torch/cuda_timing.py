"""Timing of device work with CUDA events.

Two numbers per function, both on the card's clock:

* ``device_ms``: the device time of one call, from `runs` calls captured in
  one CUDA graph and replayed between two events (no host launch gaps);
  the median over `repeats` replays.
* ``call_ms``: the latency a caller sees, host-side launch work included:
  the median of `runs` eager calls, each between two events.

Both need CUDA and raise without it.
"""

from __future__ import annotations

import statistics

import torch


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA timing needs a CUDA device; none is available")


def call_ms(fn, runs: int = 50) -> float:
    _require_cuda()
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs: int = 50, repeats: int = 5) -> float:
    _require_cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    del graph
    return statistics.median(times)
