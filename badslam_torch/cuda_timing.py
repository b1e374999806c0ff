"""Timing of device work with CUDA events.

Two numbers per function, both on the card's clock:

* ``device_ms``: the device time of one call, from `runs` calls captured in
  one CUDA graph and replayed between two events (no host launch gaps);
  the median over `repeats` replays.
* ``call_ms``: the latency a caller sees, host-side launch work included:
  the median of `runs` eager calls, each between two events.

Both need CUDA and raise without it. ``Spans`` records the elapsed time of
repeated spans of work inside a run on either device.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch


class Spans:
    """Elapsed milliseconds of repeated spans of work on one device: a pair
    of CUDA events per span on the card, resolved only when `ms` is read
    (recording adds no synchronization), the host clock on the CPU."""

    def __init__(self, device: torch.device | str):
        self.cuda = torch.device(device).type == "cuda"
        self._marks = []

    @contextlib.contextmanager
    def span(self):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._marks.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._marks.append(1000.0 * (time.perf_counter() - t0))

    def ms(self) -> list:
        out = []
        for mark in self._marks:
            if isinstance(mark, tuple):
                mark[1].synchronize()
                mark = mark[0].elapsed_time(mark[1])
            out.append(mark)
        return out


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
