"""The end-to-end readers over a synthetic record: all frames of the
window count, and a stall anywhere moves fps."""

import numpy as np

from slam_bench.metrics import fps, frame_ms_p50, frame_ms_p95, host_gap_ms, steady_frame_ms


def _record(latency, window_s, slice_frames=0):
    return {"frames": len(latency), "window_s": window_s, "latency_ms": list(latency),
            "slice_frames": slice_frames}


def test_fps_and_percentiles_over_all_frames():
    lat = [20.0] * 190 + [400.0] * 10
    r = _record(lat, sum(lat) / 1e3)
    assert abs(fps.read(r) - 200 / 7.8) < 1e-9
    assert frame_ms_p50.read(r) == 20.0
    assert frame_ms_p95.read(r) == float(np.percentile(lat, 95))
    # The tail is the tail of all frames: 10 slow frames of 200 sit at the 95th.
    assert 20.0 < frame_ms_p95.read(r) <= 400.0


def test_the_tail_leaves_out_the_traced_slice():
    lat = [500.0] * 20 + [20.0] * 200
    assert frame_ms_p95.read(_record(lat, 10.0, slice_frames=20)) == 20.0
    assert frame_ms_p95.read(_record(lat, 10.0)) > 20.0


def test_a_stall_moves_fps():
    lat = [20.0] * 200
    base = _record(lat, 4.0)
    stalled = _record(lat[:-1] + [2020.0], 6.0)
    assert fps.read(stalled) < fps.read(base)
    assert frame_ms_p50.read(stalled) == frame_ms_p50.read(base)


def test_layer_readers_over_the_untraced_frames():
    r = {"post_frames": [1, 2, 3, 4], "post_wall_s": 0.1,
         "span_ms": {1: 20.0, 2: 21.0, 3: 22.0, 4: 30.0},
         "keyframe_frames": [4], "drain_frames": [3]}
    assert abs(host_gap_ms.read(r) - (100.0 - 93.0) / 4) < 1e-12
    assert steady_frame_ms.read(r) == 20.5
