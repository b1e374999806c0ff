"""Named accumulating timer registry, and the timed region it is built on.

``region(device, sync)`` times one region of work and yields a ``Span``,
its milliseconds: on a CUDA device a pair of CUDA events recorded on that
device's current stream, resolved when the span is first read, so timing
adds no synchronization; without a device (a host thread's work, such as
the loop-detection worker) and on the CPU, the host clock. ``sync=`` a
device ends the region with ``torch.cuda.synchronize`` on it, as the JAX
package's ``sync=`` ends it with ``jax.block_until_ready``.

``Timing`` is the counterpart of ``badslam_tpu/utils/timing.py`` with the
same API (``add_time``, ``time``, ``stats``, ``reset``, ``snapshot``,
``delta``, ``report``, ``save``; ``timed``) and the same report table. Its
regions' spans are folded into their timers once their end event has
completed, when a later region closes; ``stats``, ``snapshot``, ``report``
and ``save`` wait for the rest. The registry is process-wide and guarded by
a lock, since the loop-detection worker records from its own thread.
``Spans`` keeps the spans of one object's repeated regions, read back as a
list (DirectBA's per-call and per-step times).
"""

from __future__ import annotations

import threading
import time as _time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass
class _TimerStats:
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.min = min(self.min, seconds)
        self.max = max(self.max, seconds)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Span:
    """One timed region's milliseconds (``ms``): on the host clock, or from
    a pair of CUDA events, resolved when first read (waiting for the end
    event only if it has not completed)."""

    __slots__ = ("_ms", "_events")

    def __init__(self):
        self._ms: Optional[float] = None
        self._events = None

    def done(self) -> bool:
        """Whether ``ms`` can be read without waiting."""
        return self._events is None or self._events[1].query()

    @property
    def ms(self) -> Optional[float]:
        if self._ms is None and self._events is not None:
            start, end = self._events
            if not end.query():
                end.synchronize()
            self._ms = start.elapsed_time(end)
        return self._ms


@contextmanager
def region(device=None, sync=None):
    """Time one region of `device`'s work (None: host work, on the host
    clock); `sync` (a device, or None) ends the region with a
    synchronization of that device and defaults `device` to it. Yields the
    region's Span."""
    span = Span()
    if device is None:
        device = sync
    if device is None or torch.device(device).type != "cuda":
        start = _time.perf_counter()
        try:
            yield span
        finally:
            span._ms = 1e3 * (_time.perf_counter() - start)
        return
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    try:
        yield span
    finally:
        end.record(stream)
        span._events = (start, end)
        if sync is not None:
            torch.cuda.synchronize(sync)


class Timing:
    """Process-wide registry of named accumulating timers."""

    _lock = threading.Lock()
    _timers: Dict[str, _TimerStats] = {}
    # (name, span) of the regions not yet folded into their timers.
    _pending: list = []

    @classmethod
    def add_time(cls, name: str, seconds: float) -> None:
        with cls._lock:
            cls._timers.setdefault(name, _TimerStats()).add(seconds)

    @classmethod
    def _fold(cls, wait: bool) -> None:
        """Add the pending regions' times to their timers: all of them
        (waiting for each) with `wait`, else those that are done."""
        with cls._lock:
            keep = []
            for name, span in cls._pending:
                if wait or span.done():
                    cls._timers.setdefault(name, _TimerStats()).add(span.ms / 1e3)
                else:
                    keep.append((name, span))
            cls._pending[:] = keep

    @classmethod
    @contextmanager
    def time(cls, name: str, sync=None, device=None):
        """Context manager timing one `region` of `device`'s work as timer
        `name`. Yields the region's Span."""
        with region(device, sync) as span:
            yield span
        with cls._lock:
            cls._pending.append((name, span))
        cls._fold(wait=False)

    @classmethod
    def stats(cls, name: str) -> Optional[_TimerStats]:
        cls._fold(wait=True)
        return cls._timers.get(name)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._timers.clear()
            cls._pending.clear()

    @classmethod
    def snapshot(cls) -> Dict[str, tuple]:
        """{name: (count, total_seconds)} copy of the registry (after the
        pending CUDA regions); diff two snapshots to attribute time to a
        run segment."""
        cls._fold(wait=True)
        with cls._lock:
            return {k: (st.count, st.total) for k, st in cls._timers.items()}

    @staticmethod
    def delta(before: Dict[str, tuple], after: Dict[str, tuple],
              top: int = 6) -> Dict[str, float]:
        """Per-phase seconds spent between two snapshots (top-N by time)."""
        out = {}
        for name, (cnt, total) in after.items():
            b = before.get(name, (0, 0.0))
            d = total - b[1]
            if d > 1e-4:
                out[name] = d
        return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])

    @classmethod
    def report(cls, sort_by_total: bool = True) -> str:
        cls._fold(wait=True)
        with cls._lock:
            items = sorted(
                cls._timers.items(),
                key=(lambda kv: -kv[1].total) if sort_by_total else (lambda kv: kv[0]),
            )
        lines = [
            f"{'timer':<44} {'count':>8} {'total[s]':>10} {'mean[ms]':>10}"
            f" {'min[ms]':>10} {'max[ms]':>10}"
        ]
        for name, st in items:
            lines.append(
                f"{name:<44} {st.count:>8} {st.total:>10.3f} {1e3 * st.mean:>10.3f}"
                f" {1e3 * st.min:>10.3f} {1e3 * st.max:>10.3f}"
            )
        return "\n".join(lines)

    @classmethod
    def save(cls, path: str) -> None:
        with open(path, "w") as f:
            f.write(cls.report() + "\n")


@contextmanager
def timed(name: str, sync=None, device=None):
    with Timing.time(name, sync=sync, device=device) as span:
        yield span


class Spans:
    """The spans of one object's repeated regions of `device`'s work."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self._spans = []

    @contextmanager
    def span(self):
        with region(self.device) as span:
            yield
        self._spans.append(span)

    def ms(self) -> list:
        return [span.ms for span in self._spans]
