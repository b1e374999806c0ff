"""The readers of the program's device stamps and timers, over a hand-made
record: each reads only ``timing_s`` ({timer: (count, seconds)} over the
untraced window) and ``post_wall_s``, and gives None where its timers are
missing (a program without the stamps)."""

import pytest

from slam_bench.metrics import (
    ba_geometry_ms,
    ba_iterations_per_call,
    ba_live_row_pct,
    ba_pose_ms,
    graph_busy_pct,
    loop_worker_ms,
    steady_device_ms,
)

READERS = (graph_busy_pct, steady_device_ms, ba_iterations_per_call, ba_pose_ms,
           ba_geometry_ms, ba_live_row_pct, loop_worker_ms)


def _record(timers, wall_s=20.0):
    return {"timing_s": timers, "post_wall_s": wall_s}


TIMERS = {
    "steady frame [graph]": (250, 8.5),
    "BA call [graph]": (56, 30.0),
    "closure attempt [graph]": (1, 0.1),
    "BA iteration [graph]": (392, 29.0),
    "BA pose optimization [graph]": (392, 11.2),
    "BA geometry optimization [graph]": (392, 5.6),
    "BA surfel rows [graph]": (1_000_000, 0.0),
    "BA live surfels [graph]": (640_000, 0.0),
    "keyframe insert": (28, 0.05),
    "loop detection (worker thread)": (28, 1.4),
    "bundle adjustment": (28, 20.0),
}


def test_each_reader_on_a_hand_made_record():
    r = _record(TIMERS, wall_s=50.0)
    assert graph_busy_pct.read(r) == pytest.approx(100.0 * 38.6 / 50.0)
    assert steady_device_ms.read(r) == pytest.approx(34.0)
    assert ba_iterations_per_call.read(r) == pytest.approx(7.0)
    assert ba_pose_ms.read(r) == pytest.approx(200.0)
    assert ba_geometry_ms.read(r) == pytest.approx(100.0)
    assert ba_live_row_pct.read(r) == pytest.approx(64.0)
    assert loop_worker_ms.read(r) == pytest.approx(50.0)


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_each_reader_gives_none_without_its_timers(reader):
    """The parent program has no [graph] timers; a window without keyframes
    has no BA call or insert."""
    without = {k: v for k, v in TIMERS.items() if not k.endswith("[graph]")}
    if reader is loop_worker_ms:
        without = {k: v for k, v in without.items() if k != "keyframe insert"}
    assert reader.read(_record(without)) is None
    assert reader.read(_record({})) is None


def test_busy_share_stays_within_the_window():
    r = _record({"steady frame [graph]": (10, 0.3)}, wall_s=0.4)
    assert graph_busy_pct.read(r) == pytest.approx(75.0)
    assert graph_busy_pct.read(_record({"steady frame [graph]": (10, 0.3)}, 0.0)) is None
