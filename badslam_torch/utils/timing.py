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

Inside a CUDA-graph capture a region is stamped instead (``stamped``): a
one-thread kernel captured at its start and one at its end read the card's
globaltimer and add the region's nanoseconds and one run to its row of the
device's ``StampTable``, at every replay, with no host read. ``count``
captures a counter row the same way (a device value added per run). The
host reads each table with the launch counters, once per ``BadSlam.run``
(``kernels.flush_launch_counts``), and in ``stats``, ``snapshot`` and
``report``, and folds each row into the timer ``<name> [graph]``: count =
runs and seconds = the nanoseconds; a counter row's count is its summed
value. The whole-replay regions also write (graph, frame, start, end) into
a ring of the last ``StampTable.RING`` replays, which ``device_timeline``
gives on the host clock of torch.profiler's events (``PROFILER_CLOCK``).
``Timing.stamping = False`` captures graphs without stamps.

``trace_range`` opens a torch.profiler range, except while the current
stream captures a graph: then the range would time the capture, not the
work, so it is left out.
"""

from __future__ import annotations

import bisect
import threading
import time as _time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

# The host clock of torch.profiler's events (their kineto start_ns()): the
# clock_gettime clock that device_timeline maps the globaltimer onto.
PROFILER_CLOCK = _time.CLOCK_REALTIME


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


@contextmanager
def trace_range(name: Optional[str]):
    """The torch.profiler range `name` around the block; none for None or
    while the current stream captures a graph."""
    if name is None or capturing():
        yield
        return
    with record_function(name):
        yield


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

    def add_many(self, count: int, seconds: float) -> None:
        """`count` runs of `seconds` in all (min and max take their mean)."""
        self.count += count
        self.total += seconds
        self.min = min(self.min, seconds / count)
        self.max = max(self.max, seconds / count)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Span:
    """One timed region's milliseconds (``ms``): on the host clock, or from
    a pair of CUDA events, resolved when first read (waiting for the end
    event only if it has not completed). A region stamped in a capture
    (``stamped``) has none: its runs go to the device table."""

    __slots__ = ("_ms", "_events", "stamped")

    def __init__(self):
        self._ms: Optional[float] = None
        self._events = None
        self.stamped = False

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
def region(device=None, sync=None, name: Optional[str] = None):
    """Time one region of `device`'s work (None: host work, on the host
    clock); `sync` (a device, or None) ends the region with a
    synchronization of that device and defaults `device` to it. Inside a
    CUDA-graph capture the region is stamped as `name` (``stamped``), and
    may not synchronize. Yields the region's Span."""
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
    if capturing():
        if sync is not None or name is None:
            raise RuntimeError("a region inside a CUDA-graph capture is stamped: it "
                               "needs a name and cannot synchronize")
        span.stamped = True
        with stamped(name, device):
            yield span
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


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class StampTable:
    """The device stamps of one device: an int64 table of ``ROWS`` rows
    (start of the open region, nanoseconds, runs, spare; a counter row sums
    its value where a time row sums nanoseconds), the ring's control
    (entries written, the last frame index) and a ring of the last ``RING``
    whole replays (graph row, frame index, start, end; globaltimer ns).
    Rows are registered by name at capture time. ``fold`` turns a read of
    the table into the timers' increments since the last fold.
    ``calibrations`` holds (globaltimer ns, host ns - globaltimer ns) pairs
    on ``PROFILER_CLOCK``: taken when the table is made and again at a
    flush or a ``device_timeline`` read that finds the card idle
    (``recalibrate``)."""

    ROWS = 256
    RING = 4096
    # The least span of calibrations whose drift is extrapolated.
    DRIFT_BASE_NS = 1_000_000_000
    TIME, COUNT = "time", "count"

    def __init__(self, device, calibrate: bool = True):
        self.device = _cuda_device(device)
        rows = self.ROWS * 4
        self.tensor = torch.zeros(rows + 4 + self.RING * 4, dtype=torch.int64,
                                  device=self.device)
        self.rows = self.tensor[:rows].view(self.ROWS, 4)
        self.ctl = self.tensor[rows:rows + 4]
        self.ring = self.tensor[rows + 4:].view(self.RING, 4)
        self.names: List[str] = []
        self.kinds: List[str] = []
        self._index: Dict[str, int] = {}
        # Per row, (nanoseconds or value, runs) as of the last fold.
        self._folded = np.zeros((self.ROWS, 2), np.int64)
        self._ring_seen = 0
        self.replays: deque = deque(maxlen=self.RING)
        self.calibrations: List[Tuple[int, int]] = []
        if calibrate:
            self.calibrate(8)

    def row(self, name: str, kind: str = TIME) -> int:
        """The row of `name`, registered at its first use."""
        r = self._index.get(name)
        if r is None:
            if len(self.names) >= self.ROWS:
                raise RuntimeError(f"more than {self.ROWS} stamped regions on {self.device}")
            r = self._index[name] = len(self.names)
            self.names.append(name)
            self.kinds.append(kind)
        elif self.kinds[r] != kind:
            raise ValueError(f"stamp row {name!r} is a {self.kinds[r]} row, not a {kind} row")
        return r

    def calibrate(self, trials: int) -> None:
        """Read the globaltimer beside the host clock `trials` times (on an
        idle card) and keep the pair of the shortest round trip."""
        from badslam_torch.ops import conditional

        pairs = [conditional.clock_pair(self.device, PROFILER_CLOCK) for _ in range(trials)]
        host, dev, _ = min(pairs, key=lambda p: p[2])
        self.calibrations.append((dev, host - dev))

    def recalibrate(self) -> None:
        """Calibrate again where the card is idle (nothing queued on the
        current stream): after a flush's or a timeline's read."""
        if self.device.type == "cuda" and torch.cuda.current_stream(self.device).query():
            self.calibrate(3)

    def to_host_ns(self, device_ns: int) -> int:
        """A globaltimer reading on the host clock: the offset interpolated
        linearly between the calibrations around it. Outside them the offset
        follows the drift from the first calibration to the last where those
        lie ``DRIFT_BASE_NS`` or more apart (the clocks drift by a few ppm:
        tens of microseconds in ten seconds), else the nearest offset."""
        cal = self.calibrations
        if not cal:
            raise RuntimeError(f"the stamp table on {self.device} has no calibration")
        i = bisect.bisect_right([d for d, _ in cal], device_ns) - 1
        if 0 <= i < len(cal) - 1:
            (d0, o0), (d1, o1) = cal[i], cal[i + 1]
        elif cal[-1][0] - cal[0][0] >= self.DRIFT_BASE_NS:
            (d0, o0), (d1, o1) = cal[0], cal[-1]
        else:
            return device_ns + cal[0 if i < 0 else -1][1]
        return device_ns + o0 + (o1 - o0) * (device_ns - d0) // (d1 - d0)

    def fold(self, values: np.ndarray) -> Dict[str, Tuple[int, float]]:
        """From `values`, the whole table read to the host: {timer: (count,
        seconds)} added since the last fold, and the new ring entries
        appended to ``replays``."""
        n = len(self.names)
        rows = np.asarray(values[:self.ROWS * 4]).reshape(self.ROWS, 4)[:n, 1:3]
        delta = rows - self._folded[:n]
        self._folded[:n] = rows
        out = {}
        for r in np.nonzero(delta.any(axis=1))[0]:
            value, runs = (int(v) for v in delta[r])
            timer = f"{self.names[r]} [graph]"
            if self.kinds[r] == self.COUNT:
                out[timer] = (value, 0.0)
            elif runs:
                out[timer] = (runs, value * 1e-9)
        cursor = int(values[self.ROWS * 4])
        ring = np.asarray(values[self.ROWS * 4 + 4:]).reshape(self.RING, 4)
        for k in range(max(self._ring_seen, cursor - self.RING), cursor):
            self.replays.append(tuple(int(v) for v in ring[k % self.RING]))
        self._ring_seen = cursor
        return out

    def clear(self) -> None:
        """Zero the table (on its device's current stream) and what was folded."""
        self.tensor.zero_()
        self._folded[:] = 0
        self._ring_seen = 0
        self.replays.clear()

    def timeline(self) -> List[dict]:
        """The replays in ``replays`` as dicts (graph, frame, start_ns,
        end_ns) on the host clock."""
        return [{"graph": self.names[g], "frame": f, "start_ns": self.to_host_ns(s),
                 "end_ns": self.to_host_ns(e)} for g, f, s, e in self.replays]


class Timing:
    """Process-wide registry of named accumulating timers."""

    _lock = threading.Lock()
    _timers: Dict[str, _TimerStats] = {}
    # (name, span) of the regions not yet folded into their timers.
    _pending: list = []
    # The stamp table of each CUDA device.
    _tables: Dict[torch.device, StampTable] = {}
    # Whether captures take the device stamps.
    stamping = True

    @classmethod
    def add_time(cls, name: str, seconds: float) -> None:
        with cls._lock:
            cls._timers.setdefault(name, _TimerStats()).add(seconds)

    @classmethod
    def stamp_table(cls, device) -> StampTable:
        """The stamp table of a CUDA device, made (and its clock read) at the
        first call, which must come before any capture that stamps."""
        device = _cuda_device(device)
        table = cls._tables.get(device)
        if table is None:
            if capturing():
                raise RuntimeError(f"the stamp table of {device} must be made before "
                                   f"a capture (Timing.stamp_table)")
            table = StampTable(device)
            with cls._lock:
                table = cls._tables.setdefault(device, table)
        return table

    @classmethod
    def stamp_tables(cls) -> List[StampTable]:
        with cls._lock:
            return list(cls._tables.values())

    @classmethod
    def fold_tables(cls, reads: Optional[Dict[StampTable, np.ndarray]] = None) -> None:
        """Fold the stamp tables into their timers: from `reads` ({table:
        its values, already read}), else every table read now (a device
        read each)."""
        if reads is None:
            reads = {t: t.tensor.cpu().numpy() for t in cls.stamp_tables()}
        with cls._lock:
            for table, values in reads.items():
                for name, (count, seconds) in table.fold(values).items():
                    cls._timers.setdefault(name, _TimerStats()).add_many(count, seconds)

    @classmethod
    def device_timeline(cls, device) -> List[dict]:
        """The last StampTable.RING graph replays on `device` (a device
        read, after which the clock is read again where the card is idle),
        on the host clock of torch.profiler's events."""
        cls.fold_tables()
        table = cls._tables.get(_cuda_device(device))
        if table is None:
            return []
        table.recalibrate()
        return table.timeline()

    @classmethod
    def _fold(cls, wait: bool) -> None:
        """Add the pending regions' times to their timers: all of them
        (waiting for each) and the stamp tables' with `wait`, else those
        that are done."""
        if wait:
            cls.fold_tables()
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
        `name` (stamped inside a capture: "<name> [graph]"). Yields the
        region's Span."""
        with region(device, sync, name) as span:
            yield span
        if span.stamped:
            return
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
            for table in cls._tables.values():
                table.clear()

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


@contextmanager
def stamped(name: str, device, ring: bool = False, frame: Optional[torch.Tensor] = None):
    """Inside a CUDA-graph capture (with ``Timing.stamping``), stamps at the
    start and the end of the block: each run adds its device time and one
    run to the row `name` of the device's StampTable (the timer "<name>
    [graph]"); with `ring`, each run also writes a ring entry with the frame
    index `frame` holds (a device int64, or None: the last one written).
    Elsewhere nothing."""
    if not (Timing.stamping and capturing()):
        yield
        return
    from badslam_torch.ops import conditional

    table = Timing.stamp_table(device)
    r = table.row(name)
    conditional.stamp(table.rows[r], conditional.STAMP_BEGIN_RING if ring else
                      conditional.STAMP_BEGIN, table.ctl, table.ring)
    yield
    conditional.stamp(table.rows[r], conditional.STAMP_END_RING if ring else
                      conditional.STAMP_END, table.ctl, table.ring, frame, r)


def count(name: str, value, device) -> None:
    """Inside a CUDA-graph capture (with ``Timing.stamping``), add `value` (a
    host int or a device integer scalar) to the counter row `name` at each
    run (the count of the timer "<name> [graph]"). Elsewhere nothing."""
    if Timing.stamping and capturing():
        table = Timing.stamp_table(device)
        table.rows[table.row(name, StampTable.COUNT), 1].add_(value)


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
