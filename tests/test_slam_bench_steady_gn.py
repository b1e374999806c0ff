"""The benchmark's reader of the tracker's Gauss-Newton time per steady
replay (slam_bench/metrics/steady_gn_ms.py) over hand-made records: the
seconds of the WHILE nodes' stamps of every scale over the replays, and
None where the program has no such stamps or ran no replay."""

import pytest

from slam_bench.metrics import steady_gn_ms

TIMERS = {
    "steady frame [graph]": (250, 2.5),
    "steady frame: preprocess [graph]": (250, 0.21),
    "steady frame: gn/scale0 [graph]": (250, 0.10),
    "steady frame: gn/scale1 [graph]": (250, 0.05),
    "steady frame: gn/scale4 [graph]": (250, 0.10),
    "closure attempt: gn/scale0 [graph]": (2, 0.4),
    "steady frame launch [host]": (250, 0.03),
}


@pytest.mark.parametrize("timers, want", [
    pytest.param(TIMERS, 1e3 * 0.25 / 250, id="every scale, closure loops apart"),
    pytest.param({k: v for k, v in TIMERS.items() if "gn/" not in k}, None,
                 id="no loop stamps"),
    pytest.param({k: v for k, v in TIMERS.items() if k != "steady frame [graph]"}, None,
                 id="no replay"),
])
def test_steady_gn_ms_reads_the_loop_stamps(timers, want):
    got = steady_gn_ms.read({"timing_s": timers, "post_wall_s": 20.0})
    assert got == pytest.approx(want) if want is not None else got is None
