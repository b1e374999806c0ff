"""badslam_torch.ops.autotune against badslam_tpu.ops.autotune, and
`--autotune` on the CPU.

The same no-argument variant thunks go through both packages' `autotune`:
thunks that sleep for different times (a margin of milliseconds, far
above either host clock's jitter), count their calls, or raise. The
stores are JSON files under each test's tmp directory. The CLI run is the
port's alone (64x48, 4 frames, BA and loop detection off): with
`--device cpu` there is no kernel to tune, so its poses must equal the
unflagged run's exactly and no store is written. The tests of the tuned
tiles on the card are in tests/test_torch_cuda.py.
"""

import json
import logging
import os
import time

import numpy as np
import pytest
import torch

from badslam_tpu.ops import autotune as jtuner
from badslam_torch import synthetic as tsyn
from badslam_torch.cli import main as torch_main
from badslam_torch.io import dataset as tds
from badslam_torch.ops import autotune as ttuner
from badslam_torch.ops import kernels

torch.set_num_threads(1)

FRAMES = 4
FLAGS = ["--num_scales", "3", "--keyframe_interval", "2",
         "--max_num_ba_iterations_per_keyframe", "0",
         "--enable_loop_detection", "false", "--fps_restriction", "0",
         "--max_surfel_count", str(1 << 12), "--quiet"]


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """Both packages' stores at their own tmp files; the port's cache
    starts empty."""
    paths = {"jax": str(tmp_path / "jax" / "tuning.json"),
             "torch": str(tmp_path / "torch" / "tuning.json")}
    monkeypatch.setattr(jtuner, "_TUNING_PATH", paths["jax"])
    monkeypatch.setattr(ttuner, "_TUNING_PATH", paths["torch"])
    monkeypatch.setattr(ttuner, "_cache", {})
    return paths


def _sleeper(seconds, calls=None):
    def thunk():
        if calls is not None:
            calls.append(seconds)
        time.sleep(seconds)
        return seconds
    return thunk


def _both(variants_for, iterations=3):
    """(JAX winner, port winner) of the same variants."""
    return (jtuner.autotune("k", variants_for(), iterations=iterations),
            ttuner.autotune("k", variants_for(), iterations=iterations, device="cpu"))


@pytest.mark.parametrize("order", [("slow", "fast", "mid"), ("fast", "mid", "slow")],
                         ids=["fast_second", "fast_first"])
def test_same_winner_as_jax(stores, order):
    seconds = {"slow": 0.004, "mid": 0.002, "fast": 0.0}
    jax_best, torch_best = _both(lambda: {n: _sleeper(seconds[n]) for n in order})
    assert jax_best == torch_best == "fast"
    assert set(ttuner.last_times) == set(order)
    assert ttuner.last_times["fast"] < ttuner.last_times["mid"] < ttuner.last_times["slow"]


@pytest.mark.parametrize("iterations", [1, 4])
def test_each_variant_called_one_plus_iterations(stores, iterations):
    counts = {}
    for package in (jtuner, ttuner):
        calls = {"a": [], "b": []}
        extra = {"device": "cpu"} if package is ttuner else {}
        package.autotune("k", {n: _sleeper(0.0, calls[n]) for n in calls},
                         iterations=iterations, **extra)
        counts[package.__name__] = {n: len(c) for n, c in calls.items()}
    assert counts[jtuner.__name__] == counts[ttuner.__name__] == {
        "a": 1 + iterations, "b": 1 + iterations}


def _raiser():
    raise RuntimeError("no launch")


def test_raising_variant_is_skipped(stores, caplog):
    variants = lambda: {"broken": _raiser, "slow": _sleeper(0.003),  # noqa: E731
                        "fast": _sleeper(0.0)}
    with caplog.at_level(logging.WARNING, logger=ttuner.__name__):
        jax_best, torch_best = _both(variants)
    assert jax_best == torch_best == "fast"
    skipped = [r.getMessage() for r in caplog.records if r.name == ttuner.__name__]
    assert len(skipped) == 1 and "broken" in skipped[0] and "no launch" in skipped[0]
    assert "broken" not in ttuner.last_times


def test_all_raising_gives_none_and_writes_nothing(stores):
    jax_best, torch_best = _both(lambda: {"a": _raiser, "b": _raiser})
    assert jax_best is None and torch_best is None
    assert not os.path.exists(stores["jax"]) and not os.path.exists(stores["torch"])


def test_winner_is_persisted_under_the_same_key_as_jax(stores):
    _both(lambda: {"slow": _sleeper(0.003), "fast": _sleeper(0.0)})
    with open(stores["jax"]) as f:
        jax_store = json.load(f)
    with open(stores["torch"]) as f:
        torch_store = json.load(f)
    assert jax_store == torch_store == {"cpu:k": "fast"}
    assert ttuner.device_key("k", "cpu") == jtuner.backend_key("k") == "cpu:k"
    assert ttuner.get("cpu:k") == jtuner.get("cpu:k") == "fast"


def test_entry_points_default_to_the_card(stores):
    """autotune and device_key target the card unless the caller asks for
    the CPU, and raise without CUDA (as DirectBA does): a call on the card's
    machine never times the CPU's enqueue of CUDA work by accident."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttuner.device_key("k")
    calls = []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttuner.autotune("k", {"a": _sleeper(0.0, calls)})
    assert calls == [] and not os.path.exists(stores["torch"])


def test_store_round_trips(stores, monkeypatch):
    ttuner.put("NVIDIA H100 80GB HBM3:bilateral_480x640", "8x2")
    ttuner.put("cpu:other", 3)
    ttuner._cache.clear()  # a new process reads the file
    assert ttuner.get("NVIDIA H100 80GB HBM3:bilateral_480x640") == "8x2"
    assert ttuner.get("cpu:other") == 3
    assert ttuner.get("absent", "default") == "default"
    monkeypatch.setattr(jtuner, "_TUNING_PATH", stores["torch"])  # the JAX store's layout
    assert jtuner.get("cpu:other") == 3


def test_store_is_read_once_and_put_updates_it(stores):
    ttuner.put("cpu:a", "1")
    with open(stores["torch"], "w") as f:  # another process rewrites the file
        json.dump({"cpu:a": "2"}, f)
    assert ttuner.get("cpu:a") == "1"  # the cache, not the file
    ttuner.put("cpu:b", "3")
    assert ttuner.get("cpu:b") == "3"
    with open(stores["torch"]) as f:
        assert json.load(f) == {"cpu:a": "1", "cpu:b": "3"}


def test_a_broken_store_names_its_file(stores):
    os.makedirs(os.path.dirname(stores["torch"]))
    with open(stores["torch"], "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError, match="tuning.json is not a tuning store"):
        ttuner.get("cpu:a")


def test_stored_tile_is_read_and_an_unknown_one_raises(stores):
    tiles = [(8, 2), (8, 1)]  # the table as the library returns it
    key = "NVIDIA H100 80GB HBM3:bilateral_48x64"
    assert kernels.stored_bilateral_tile(key, tiles) is None
    ttuner.put(key, kernels.tile_name((8, 1)))
    assert kernels.stored_bilateral_tile(key, tiles) == (8, 1)
    ttuner.put(key, "4x4")
    with pytest.raises(ValueError, match=r"tuning\.json: .*'4x4'.*8x2, 8x1"):
        kernels.stored_bilateral_tile(key, tiles)


def test_default_tile_is_looked_up_once_per_store_change(stores, monkeypatch):
    """A default launch reads the store once per card and size, and again
    after a put; a tile asked for by name skips the store."""
    monkeypatch.setattr(kernels, "_tiles", [(8, 2), (8, 1)])  # the library's table
    monkeypatch.setattr(kernels, "_tuned", {})
    lookups = []

    def device_key(key, device="cpu"):
        lookups.append(key)
        return f"card:{key}"

    monkeypatch.setattr(ttuner, "device_key", device_key)
    card = torch.device("cuda", 0)  # a device name; nothing is launched
    assert kernels._tile_index(None, card, 48, 64) == (0, (8, 2))
    assert kernels._tile_index(None, card, 48, 64) == (0, (8, 2))
    assert lookups == ["bilateral_48x64"]
    ttuner.put("card:bilateral_48x64", "8x1")
    assert kernels._tile_index(None, card, 48, 64) == (1, (8, 1))
    assert kernels._tile_index(None, card, 24, 32) == (0, (8, 2))
    assert lookups == ["bilateral_48x64", "bilateral_48x64", "bilateral_24x32"]
    assert kernels._tile_index((8, 2), card, 48, 64) == (0, (8, 2))
    assert len(lookups) == 3


def test_autotune_preprocess_on_cpu_tunes_nothing(stores, caplog):
    with caplog.at_level(logging.WARNING, logger=kernels.__name__):
        assert kernels.autotune_preprocess(48, 64, max_depth=3.0, device="cpu") is None
    lines = [r.getMessage() for r in caplog.records if r.name == kernels.__name__]
    assert len(lines) == 1 and "nothing to tune on the CPU" in lines[0]
    assert not os.path.exists(stores["torch"])
    with pytest.raises(ValueError, match="tunes a CUDA kernel"):
        kernels.autotune_bilateral_tile(48, 64, device="cpu")


def _trajectory(path):
    _, poses = tds.load_tum_trajectory(path)
    return (np.stack([p.q for p in poses]).astype(np.float64),
            np.stack([p.t for p in poses]).astype(np.float64))


def test_cli_autotune_on_cpu_matches_the_unflagged_run(stores, tmp_path):
    data = str(tmp_path / "seq")
    tsyn.write_tum_dataset(data, tsyn.default_camera(64, 48),
                           tsyn.random_plane_scene(np.random.default_rng(5), 6),
                           tsyn.smooth_trajectory(FRAMES))
    runs = {}
    for tag, extra in (("plain", []), ("autotune", ["--autotune"])):
        out = str(tmp_path / f"{tag}.txt")
        assert torch_main([data, "--device", "cpu", *FLAGS, *extra,
                           "--export_poses", out]) == 0
        runs[tag] = _trajectory(out)
    (qp, tp), (qa, ta) = runs["plain"], runs["autotune"]
    assert qp.shape == (FRAMES, 4)
    np.testing.assert_array_equal(qa, qp)
    np.testing.assert_array_equal(ta, tp)
    assert not os.path.exists(stores["torch"])


def test_cli_autotune_on_cuda_without_a_card_raises(stores, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main([str(tmp_path), "--device", "cuda", "--autotune", *FLAGS])
    assert not os.path.exists(stores["torch"])
