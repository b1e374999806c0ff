"""badslam_torch's timing surface against the JAX package's: the timer
registry (badslam_torch/utils/timing.py), the memory line
(utils/memory.py), DirectBA's timing rows (fused and, under
sync_stage_profiling, staged) and the CLI's --save_timings,
--export_final_timings and end-of-run report.

Tolerances:
  * the report table: character for character, for the same add_time
    calls; snapshot and delta: equal;
  * rows: the same keys in the same order, and equal BA_count,
    inner_iteration, fused_iterations, keyframe_count and surfel_bound (the
    host-known surfel bound, known_surfel_bound in both packages; it bounds
    the surfel count); their ms are times and differ;
  * poses under sync_stage_profiling against the JAX package's staged run:
    atol 1e-4 (tests/test_torch_ba.py's and test_torch_slice.py's hold; two
    float orders); the port's unflagged run with and without --save_timings:
    bit for bit;
  * timer names: the JAX package's, less the three that time its fused
    steady-frame program and scan chunks (not ported);
  * the device stamps' table (a CPU tensor standing in for the card's):
    counts and seconds folded exactly; the globaltimer-to-host mapping
    exact in integers; BA stages timed outside a capture only under
    sync_stage_profiling, and inside one stamped with no profiler range.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from badslam_tpu import synthetic as jsyn
from badslam_tpu.cli import main as jax_main
from badslam_tpu.geometry import se3 as jse3
from badslam_tpu.utils.timing import Timing as JTiming
from badslam_torch import convert
from badslam_torch import synthetic as tsyn
from badslam_torch.cli import main as torch_main
from badslam_torch.utils import memory
from badslam_torch.utils.timing import Spans, StampTable, Timing, timed

from test_torch_mapping import DEV, Pair

torch.set_num_threads(1)

POSE_ATOL = 1e-4
# The timers of the steady frame and its chunks (badslam_torch/steady.py),
# the JAX package's names for its fused program and scan chunks.
STEADY_TIMERS = {"frame (fused)", "frame chunk (fused)", "frame chunk upload"}
STAGES = ("BA_surfel_creation", "BA_surfel_activation", "BA_geometry_optimization",
          "BA_surfel_merge", "BA_surfel_compaction", "BA_pose_optimization")
CLI_FLAGS = ["--num_scales", "3", "--max_surfel_count", str(1 << 13),
             "--keyframe_interval", "6", "--fps_restriction", "0", "--quiet"]


@pytest.fixture
def registries():
    """Both packages' process-wide registries, empty, and emptied after."""
    JTiming.reset()
    Timing.reset()
    yield
    JTiming.reset()
    Timing.reset()


def _feed(timing):
    for name, seconds in (("odometry", 0.0123), ("bundle adjustment", 0.25),
                          ("odometry", 0.0071), ("BA surfel merge", 1e-5),
                          ("a timer with a name longer than the report's column", 3.5)):
        timing.add_time(name, seconds)


def test_timing_report_matches_jax(registries, tmp_path):
    _feed(JTiming)
    _feed(Timing)
    for sort_by_total in (True, False):
        assert (Timing.report(sort_by_total=sort_by_total)
                == JTiming.report(sort_by_total=sort_by_total))
    JTiming.save(str(tmp_path / "jax.txt"))
    Timing.save(str(tmp_path / "torch.txt"))
    assert (tmp_path / "jax.txt").read_text() == (tmp_path / "torch.txt").read_text()
    st, sj = Timing.stats("odometry"), JTiming.stats("odometry")
    assert (st.count, st.total, st.min, st.max, st.mean) == (
        sj.count, sj.total, sj.min, sj.max, sj.mean)
    assert Timing.stats("absent") is None


def test_timing_snapshot_and_delta_match_jax(registries):
    _feed(JTiming)
    _feed(Timing)
    before_j, before_t = JTiming.snapshot(), Timing.snapshot()
    assert before_t == before_j
    for timing in (JTiming, Timing):
        timing.add_time("odometry", 0.5)
        timing.add_time("preprocessing", 0.002)
        timing.add_time("bundle adjustment", 0.00001)  # below delta's 1e-4 s
    after_j, after_t = JTiming.snapshot(), Timing.snapshot()
    assert after_t == after_j
    for top in (1, 6):
        assert (Timing.delta(before_t, after_t, top=top)
                == JTiming.delta(before_j, after_j, top=top))


def test_timing_regions_on_the_host(registries):
    """Regions without a device, and on the CPU, use the host clock; the
    span carries the region's ms, as do those a Spans keeps."""
    with Timing.time("host region") as span:
        sum(range(1000))
    with timed("cpu region", device="cpu") as cpu_span, Timing.time("nested", sync="cpu"):
        torch.ones(8).sum()
    assert span.ms > 0 and cpu_span.ms > 0
    assert Timing.stats("host region").count == 1
    assert set(Timing.snapshot()) == {"host region", "cpu region", "nested"}
    spans = Spans("cpu")
    for _ in range(3):
        with spans.span():
            torch.ones(8).sum()
    assert len(spans.ms()) == 3 and all(ms > 0 for ms in spans.ms())
    assert set(Timing.snapshot()) == {"host region", "cpu region", "nested"}


def test_timing_registry_is_thread_safe(registries):
    """The loop-detection worker records beside the front end's thread:
    16 threads adding to shared timers with a short switch interval lose
    no update."""
    import sys
    import threading

    def work(i):
        for _ in range(500):
            Timing.add_time("shared", 1e-3)
            with Timing.time(f"own {i % 4}"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = Timing.snapshot()
    assert snap["shared"][0] == 16 * 500
    assert snap["shared"][1] == pytest.approx(16 * 500 * 1e-3)
    assert sum(snap[f"own {j}"][0] for j in range(4)) == 16 * 500


def test_stamp_table_folds_into_graph_timers(registries):
    """A stand-in device table (a CPU tensor) folds each time row into the
    timer "<name> [graph]" with count = runs and seconds = nanoseconds, a
    counter row with its summed value as the count, only what was added
    since the last fold, and its ring's new entries (the last RING of
    them) into the replays."""
    table = StampTable("cpu", calibrate=False)
    call, iteration = table.row("BA call"), table.row("BA iteration")
    rows = table.row("BA surfel rows", StampTable.COUNT)
    table.row("closure attempt")  # registered, never run
    assert table.row("BA call") == call
    with pytest.raises(ValueError):
        table.row("BA surfel rows")
    table.rows[call, 1:3] = torch.tensor([3_000_000, 2])
    table.rows[iteration, 1:3] = torch.tensor([2_500_000, 7])
    table.rows[rows, 1] = 4096
    Timing.fold_tables({table: table.tensor.numpy().copy()})
    snap = Timing.snapshot()
    assert set(snap) == {"BA call [graph]", "BA iteration [graph]", "BA surfel rows [graph]"}
    assert snap["BA call [graph]"] == (2, pytest.approx(3e-3))
    assert snap["BA iteration [graph]"] == (7, pytest.approx(2.5e-3))
    assert snap["BA surfel rows [graph]"] == (4096, 0.0)
    table.rows[call, 1:3] += torch.tensor([5_000_000, 1])
    table.rows[rows, 1] += 1000
    table.ctl[0] = 2
    table.ring[0] = torch.tensor([call, 5, 100, 200])
    table.ring[1] = torch.tensor([call, 6, 300, 450])
    Timing.fold_tables({table: table.tensor.numpy().copy()})
    st = Timing.stats("BA call [graph]")
    assert (st.count, st.total) == (3, pytest.approx(8e-3))
    assert (st.min, st.max) == (pytest.approx(1.5e-3), pytest.approx(5e-3))
    assert Timing.stats("BA surfel rows [graph]").count == 5096
    assert Timing.stats("BA iteration [graph]").count == 7
    assert list(table.replays) == [(call, 5, 100, 200), (call, 6, 300, 450)]
    # A ring that wrapped since the last fold gives its last RING entries.
    table.ctl[0] = 2 + StampTable.RING + 3
    table.ring[:, 0] = call
    table.ring[:, 1] = torch.arange(StampTable.RING)
    Timing.fold_tables({table: table.tensor.numpy().copy()})
    assert len(table.replays) == StampTable.RING
    assert [r[1] for r in list(table.replays)[:2]] == [5, 6]
    table.clear()
    assert not table.tensor.any() and not table.replays


def test_globaltimer_mapping_is_exact_on_known_offsets():
    """globaltimer ns onto the host clock: the calibration's offset at each
    end, interpolated linearly between two, beyond the ends the nearest
    offset, or the drift from the first to the last where they lie a second
    or more apart, in exact integers at the clocks' real magnitudes."""
    table = StampTable("cpu", calibrate=False)
    d0 = 1_792_296_198_250_365_176
    table.calibrations = [(d0, -3_000_000_000), (d0 + 10_000_000, -2_999_999_000)]
    assert table.to_host_ns(d0) == d0 - 3_000_000_000
    assert table.to_host_ns(d0 - 7) == d0 - 7 - 3_000_000_000
    assert table.to_host_ns(d0 + 5_000_000) == d0 + 5_000_000 - 2_999_999_500
    assert table.to_host_ns(d0 + 10_000_000) == d0 + 10_000_000 - 2_999_999_000
    assert table.to_host_ns(d0 + 99_000_000) == d0 + 99_000_000 - 2_999_999_000
    # Calibrations a second or more apart: their drift (3 ppm here) carries
    # the offset on beyond either end.
    table.calibrations.append((d0 + 2_000_000_000, -2_999_994_000))
    assert table.to_host_ns(d0 + 1_005_000_000) == d0 + 1_005_000_000 - 2_999_996_500
    assert table.to_host_ns(d0 + 12_000_000_000) == d0 + 12_000_000_000 - 2_999_964_000
    assert table.to_host_ns(d0 - 1_000_000_000) == d0 - 1_000_000_000 - 3_000_003_000
    table.calibrations = table.calibrations[:2]
    call = table.row("steady frame")
    table.replays.append((call, 12, d0 + 1_000, d0 + 2_000))
    assert table.timeline() == [{"graph": "steady frame", "frame": 12,
                                 "start_ns": d0 + 1_000 - 3_000_000_000 + 0,
                                 "end_ns": d0 + 2_000 - 3_000_000_000 + 0}]


def _cpu_ba(**config):
    from badslam_torch.ba.scheme import DirectBA
    from badslam_torch.config import BadSlamConfig

    return DirectBA(tsyn.default_camera(32, 24), BadSlamConfig(max_surfel_count=1 << 8,
                                                               **config), device="cpu")


@pytest.mark.parametrize("staged", [False, True], ids=["unflagged", "staged"])
def test_ba_stage_outside_a_capture_times_only_when_staged(registries, staged):
    """Outside a capture, DirectBA._stage opens its profiler range and adds
    its timer (and timing row) only under sync_stage_profiling."""
    from torch.profiler import ProfilerActivity, profile

    ba = _cpu_ba(sync_stage_profiling=staged)
    rows = io.StringIO()
    ba.set_save_timings(rows)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ba._stage("BA pose optimization", "ba/poses", "ignored"):
            torch.ones(8).sum()
        with ba._stage(None, "ba/scheme_end", "BA scheme end"):
            pass
    keys = {e.key for e in prof.key_averages()}
    assert {"ba/poses", "ba/scheme_end"} <= keys
    assert set(Timing.snapshot()) == ({"BA pose optimization"} if staged else set())
    assert rows.getvalue().startswith("BA_pose_optimization ") == staged


def test_ba_stage_inside_a_capture_stamps_and_opens_no_range(registries, monkeypatch):
    """While the stream captures (here pretended), a stage is stamped under
    its graph name and opens no profiler range, sync_stage_profiling or
    not, and trace_range opens none either."""
    from torch.profiler import ProfilerActivity, profile

    from badslam_torch.ba import scheme
    from badslam_torch.utils import timing

    stamps = []

    @contextlib.contextmanager
    def stamp(name, device, **_):
        stamps.append((name, str(device)))
        yield

    monkeypatch.setattr(scheme, "capturing", lambda: True)
    monkeypatch.setattr(scheme, "stamped", stamp)
    monkeypatch.setattr(timing, "capturing", lambda: True)
    ba = _cpu_ba(sync_stage_profiling=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ba._stage("BA surfel merge", "ba/merge", "BA surfel upkeep"):
            with timing.trace_range("ba/position"):
                torch.ones(8).sum()
        with ba._stage("BA pose optimization", "ba/poses"):
            pass
    keys = {e.key for e in prof.key_averages()}
    assert not keys & {"ba/merge", "ba/position", "ba/poses"}
    assert stamps == [("BA surfel upkeep", "cpu"), ("BA pose optimization", "cpu")]
    assert Timing.snapshot() == {}


def test_capture_reasons_name_what_changed():
    """A BA graph's capture names the parts of its key that differ from the
    graph it replaced; a steady graph's the key fields that changed."""
    from badslam_torch.ba import graph as bag
    from badslam_torch.ba.scheme import FusedCall
    from badslam_torch.config import BadSlamConfig
    from badslam_torch import steady

    call = FusedCall(False, True, True, True, True, True)
    key = bag.BAKey(call, 8, False, 1024, True, True, 40.0, 4, 2.0, "cam", (1, 2), ())
    assert bag.capture_reason(key, None) == "first"
    assert bag.capture_reason(key._replace(surfel_bucket=2048), key) == "surfel bucket"
    assert bag.capture_reason(key._replace(keyframe_bucket=16, storage=(2, 2)),
                              key) == "keyframe bucket+storage"
    assert bag.capture_reason(key._replace(call=call._replace(end_first=True)),
                              key) == "call kind"
    assert bag.capture_reason(key._replace(cam="other", mesh=(("cpu",), False)),
                              key) == "camera+mesh"
    sk = steady.steady_key(BadSlamConfig())
    g = steady._GraphKey(sk, "cam", ("cam",), False, False, (8, 2), (48, 64))
    assert steady.capture_reason(g, None) == "first"
    assert steady.capture_reason(g._replace(test_two=True), g) == "test_two"
    assert steady.capture_reason(g._replace(steady=sk._replace(max_depth=2.0),
                                            shape=(96, 128)), g) == "max_depth+shape"


def test_memory_line_without_a_device():
    assert memory.device_memory_stats("cpu") is None
    assert memory.free_device_memory_mb("cpu") is None
    assert memory.format_memory_usage("cpu") == "device memory stats unavailable"


def _ba_rows(staged: bool, iters: int = 4):
    """tests/test_ba.py::_run_ba_variant in both packages (seed 13: keyframe
    0 with its surfels, keyframe 1 perturbed; moved-based deactivation),
    with a timings stream on each: (JAX rows, port rows, Pair)."""
    p = Pair(13, sync_stage_profiling=staged, disable_deactivation=False)
    gt1 = jsyn.pose(tx=0.03, ty=0.01, rz=0.01)
    kf0 = p.add(jse3.identity(), 0)
    p.create(kf0, False)
    p.add(gt1, 1)
    bad = jse3.mul(gt1, jsyn.pose(tx=0.004, ty=-0.003, rz=0.001))
    p.j.keyframes.set_pose(1, bad)
    p.t.keyframes.set_pose(1, convert.pose_from_numpy(np.asarray(bad.q),
                                                      np.asarray(bad.t), DEV))
    streams = io.StringIO(), io.StringIO()
    p.j.set_save_timings(streams[0])
    p.t.set_save_timings(streams[1])
    p.j.bundle_adjustment(max_iterations=iters)
    p.t.bundle_adjustment(max_iterations=iters)
    return (*(s.getvalue().splitlines() for s in streams), p)


def _fields(row: str) -> dict:
    words = row.split()
    return dict(zip(words[::2], words[1::2]))


def _assert_rows_match(jrows, trows, surfels: int):
    """The same keys in the same order; the counting fields and the surfel
    bound equal; the bound bounds the surfel count; every ms a number."""
    assert [r.split()[0] for r in trows] == [r.split()[0] for r in jrows]
    for jr, tr in zip(jrows, trows):
        jf, tf = _fields(jr), _fields(tr)
        assert list(tf) == list(jf), (tr, jr)
        for key in ("BA_count", "inner_iteration", "fused_iterations", "keyframe_count",
                    "surfel_bound"):
            assert tf.get(key) == jf.get(key), (key, tr, jr)
        if "surfel_bound" in tf:
            assert int(tf["surfel_bound"]) >= surfels
        for key in set(tf) & {"sync_ms", *STAGES}:
            assert float(tf[key]) >= 0.0


@pytest.mark.parametrize("staged", [False, True], ids=["fused", "staged"])
def test_ba_timing_rows_match_jax(staged):
    """One BA call of 4 iterations: a fused row per call, or under
    sync_stage_profiling a header and six stage rows per iteration (every
    iteration runs), with the JAX package's keys and counts; the poses
    agree with the JAX package's run of the same mode."""
    jrows, trows, p = _ba_rows(staged)
    assert len(jrows) == (4 * (1 + len(STAGES)) if staged else 1)
    if staged:
        assert [r.split()[0] for r in jrows[:7]] == ["BA_count", *STAGES]
    _assert_rows_match(jrows, trows, p.t.surfel_count)
    k = p.t.keyframes.count
    np.testing.assert_allclose(p.t.keyframes.q[:k].numpy(),
                               np.asarray(p.j.keyframes.q)[:k], atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(p.t.keyframes.t[:k].numpy(),
                               np.asarray(p.j.keyframes.t)[:k], atol=POSE_ATOL, rtol=0)
    # The fused row carries the budget; the port's call (and the JAX
    # package's device loop) may exit early, the staged call may not.
    assert p.t.iterations_run == [4] if staged else 1 <= p.t.iterations_run[0] <= 4


def _write_sequence(path, width, height, frames=13, seed=6):
    tsyn.write_tum_dataset(path, tsyn.default_camera(width, height),
                           tsyn.random_plane_scene(np.random.default_rng(seed), 4),
                           tsyn.smooth_trajectory(frames))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's CLI on one 96x72 sequence, each set of extra flags run
    once per module: run(extra, rows=True) -> the texts of its "poses",
    "report" and (with `rows`) "rows" files."""
    root = tmp_path_factory.mktemp("port_runs")
    path = str(root / "dataset")
    _write_sequence(path, 96, 72)
    runs = {}

    def run(extra, rows=True):
        key = (tuple(extra), rows)
        if key not in runs:
            files = {k: str(root / f"{len(runs)}_{k}.txt") for k in ("rows", "poses", "report")}
            assert torch_main([path, "--device", "cpu", *CLI_FLAGS, *extra,
                               *(["--save_timings", files["rows"]] if rows else []),
                               "--export_poses", files["poses"],
                               "--export_final_timings", files["report"]]) == 0
            runs[key] = {k: open(v).read() for k, v in files.items()
                         if rows or k != "rows"}
        return runs[key]

    return run


STAGED = ["--sync_stage_profiling", "true"]


def test_save_timings_rows(port_run):
    """The port's twin of tests/test_e2e.py::test_save_timings_rows:
    --save_timings streams fused rows by default and per-stage rows with
    sync_stage_profiling; --export_final_timings writes the report table.
    Without the flag the rows change nothing: the trajectory with
    --save_timings equals the one without, bit for bit."""
    plain, fused, staged = port_run([], rows=False), port_run([]), port_run(STAGED)
    np.testing.assert_array_equal(np.loadtxt(io.StringIO(fused["poses"])),
                                  np.loadtxt(io.StringIO(plain["poses"])))

    rows = fused["rows"].splitlines()
    assert rows and all(r.startswith("BA_count ") and "fused_iterations" in r
                        and "keyframe_count" in r and "sync_ms" in r for r in rows), rows
    srows = staged["rows"].splitlines()
    assert any(r.startswith("BA_pose_optimization ") for r in srows), srows
    assert any("inner_iteration" in r for r in srows)
    assert not any("fused_iterations" in r for r in srows)
    report = staged["report"].splitlines()
    assert report[0] == JTiming.report().splitlines()[0]
    names = {line[:44].rstrip() for line in report[1:]}
    # The first frame takes the per-frame path, every later frame the
    # steady frame (frames 1-5 as one chunk), as in the JAX package.
    assert {"BA pose optimization", "bundle adjustment", "preprocessing"} | STEADY_TIMERS <= names
    assert "odometry" not in names
    assert "BA iterations (fused)" not in names


def test_cli_rows_and_timers_match_jax_cli(tmp_path):
    """Both CLIs on one 7-frame sequence at input pyramid level 1 (128x96
    frames processed at 64x48: the JAX package then takes its per-frame
    path) over two scales, with loop detection on its worker thread,
    --sync_stage_profiling true, --save_timings and --export_final_timings:
    the same rows, poses within 1e-4, and the same timer names, none of the
    steady frame's."""
    path = str(tmp_path / "dataset")
    _write_sequence(path, 128, 96, frames=7)
    flags = ["--num_scales", "2", *CLI_FLAGS[2:], "--pyramid_level_for_depth", "1",
             "--pyramid_level_for_color", "1", *STAGED]
    out = {}
    for tag, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        out[tag] = {k: str(tmp_path / f"{tag}_{k}.txt") for k in ("rows", "report", "poses")}
        JTiming.reset()
        assert main([path, *extra, *flags, "--save_timings", out[tag]["rows"],
                     "--export_final_timings", out[tag]["report"],
                     "--export_poses", out[tag]["poses"]]) == 0
    JTiming.reset()
    jrows = open(out["jax"]["rows"]).read().splitlines()
    trows = open(out["torch"]["rows"]).read().splitlines()
    # At least one BA call of two iterations: headers and stage rows.
    assert len(jrows) >= 2 * (1 + len(STAGES))
    _assert_rows_match(jrows, trows, 1)

    tq, jq = np.loadtxt(out["torch"]["poses"]), np.loadtxt(out["jax"]["poses"])
    np.testing.assert_allclose(tq[:, 1:], jq[:, 1:], atol=POSE_ATOL, rtol=0)

    def names(report):
        lines = open(report).read().splitlines()
        return {line[:44].rstrip() for line in lines[1:]}

    jnames, tnames = names(out["jax"]["report"]), names(out["torch"]["report"])
    assert {"preprocessing", "odometry", "BA surfel creation",
            "loop detection (worker thread)"} <= jnames
    assert tnames == jnames and not tnames & STEADY_TIMERS


def test_mesh_timing_rows(port_run):
    """BA over a 2-shard mesh on the CPU: under sync_stage_profiling, the
    one-device run's row keys and poses (as on one device, activation runs
    in the geometry pass, with an empty activation stage); without it,
    fused rows with the planes replicated, and none with them streamed, as
    the JAX package writes, whose streamed calls time "BA iterations
    (streamed)"."""
    runs = {"one": port_run(STAGED),
            "mesh": port_run([*STAGED, "--n_devices", "2"]),
            "integrated": port_run(["--n_devices", "2"]),
            "streamed": port_run(["--n_devices", "2", "--plane_replication_budget_mb", "0"])}
    keys = {tag: [r.split()[0] for r in run["rows"].splitlines()] for tag, run in runs.items()}
    assert keys["mesh"] == keys["one"] and "BA_surfel_activation" in keys["mesh"]
    np.testing.assert_allclose(np.loadtxt(io.StringIO(runs["mesh"]["poses"])),
                               np.loadtxt(io.StringIO(runs["one"]["poses"])),
                               atol=POSE_ATOL, rtol=0)
    assert keys["integrated"] and set(keys["integrated"]) == {"BA_count"}
    assert "fused_iterations" in runs["integrated"]["rows"]
    assert keys["streamed"] == []
    assert "BA iterations (streamed)" in runs["streamed"]["report"]
    assert "BA iterations (fused)" in runs["integrated"]["report"]
