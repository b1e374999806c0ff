"""One reader per metric, found by the metric's name in BENCHMARK.json:
``metrics/<name>.py`` defines ``read(record)``, which returns the metric's
value from one run's record (``bench.py``), or None where the record holds
nothing to read it from (the harness then leaves the metric out).

The record's keys: ``frames`` and ``window_s`` (the window's frames and
host seconds, ending with a synchronize), ``setup_s``, ``latency_ms`` (each
window frame's time on the benchmark's own device clock, from the previous
pose write to its own), ``slice_frames`` (how many of them, first, ran
under the profiler), ``post_frames`` (the window's frames after the
traced slice; all of them untraced), ``post_wall_s``, ``span_ms`` (the
program's per-frame spans, ``BadSlam.frame_times_ms``, of those frames),
``keyframe_frames`` and ``drain_frames`` among them, ``ba_ms``
(``DirectBA.ba_spans`` of their BA calls), ``captures`` (the
``BAGraph.captures`` records made then), ``gn_iterations`` (the steady
frames' Gauss-Newton iterations then), ``timing_s`` ({timer: (count,
seconds)} of the program's ``Timing`` registry then), ``peak_bytes``
(``torch.cuda.max_memory_allocated`` over set-up and window), ``trace``
(``trace.reduce`` of the traced slice, or None) and ``k1_least_s`` (K1's
least time on each frame of the slice).
"""
