"""The traffic generator: deterministic per seed, other texture and noise
on another seed, the same geometry and motion on every seed."""

import math

import numpy as np
import pytest
import torch

from slam_bench import scene

CAM = {"width": 64, "height": 48, "fx": 53.54, "fy": 53.92, "cx": 32.06, "cy": 24.81}


def _render(mix, seed):
    return scene.render(CAM, scene.load_mix(mix), 12, 30.0, seed, 1 / 5000, "cpu")


@pytest.mark.parametrize("mix", ["corridor_walk", "desk_hover"])
def test_deterministic_per_seed(mix):
    a, b = _render(mix, 2**31 + 11), _render(mix, 2**31 + 11)
    assert np.array_equal(a.depth_u16, b.depth_u16)
    assert np.array_equal(a.color_u8, b.color_u8)


@pytest.mark.parametrize("mix", ["corridor_walk", "desk_hover"])
def test_seeds_differ_in_texture_and_noise_only(mix):
    a, b = _render(mix, 3), _render(mix, 4)
    assert not np.array_equal(a.color_u8, b.color_u8)
    assert not np.array_equal(a.depth_u16, b.depth_u16)
    # The same surfaces at the same places: the valid pixels agree and the
    # depths differ by the noise alone.
    assert np.array_equal(a.depth_u16 > 0, b.depth_u16 > 0)
    both = (a.depth_u16 > 0) & (b.depth_u16 > 0)
    d = np.abs(a.depth_u16[both].astype(np.float64) - b.depth_u16[both]) / 5000.0
    assert np.median(d) < 0.05
    assert np.array_equal(a.gt_q, b.gt_q) and np.array_equal(a.gt_t, b.gt_t)


def test_speeds_are_the_sources():
    walk = scene.motion_summary(scene.load_mix("corridor_walk"), 2600, 30.0)
    hover = scene.motion_summary(scene.load_mix("desk_hover"), 2600, 30.0)
    assert abs(walk["speed_mps"] - 0.334) < 0.02 and abs(walk["rotation_dps"] - 29.9) < 1.0
    assert abs(hover["speed_mps"] - 0.058) < 0.005 and abs(hover["rotation_dps"] - 1.7) < 0.2


def test_large_seed():
    s = _render("corridor_walk", 2**33 + 5)
    assert s.depth_u16.shape == (12, 48, 64) and (s.depth_u16 > 0).any()


def _bare(scene_spec, motion):
    """A mix with no noise and a flat albedo around `scene_spec`."""
    return {"scene": scene_spec, "albedo": {"cell_m": 0.06, "lo": 0.5, "hi": 0.5},
            "motion": dict({"start_m": [0.0, 0.0, 0.0], "velocity_mps": [0.0, 0.0, 0.0],
                            "position_sines": [], "rotation_sines": []}, **motion),
            "sensor": {"min_range_m": 0.1, "max_range_m": 20.0, "depth_noise": 0.0,
                       "depth_bias_quadratic": 0.0, "intensity_noise": 0.0}}


def test_a_box_is_ray_cast_in_front_of_a_plane():
    mix = _bare({"planes": [[[0.0, 0.0, 3.0], [0.0, 0.0, -1.0]]],
                 "boxes": [[[-0.2, -0.2, 1.5], [0.2, 0.2, 1.9]]]}, {})
    s = scene.render(CAM, mix, 1, 30.0, 1, 1 / 5000, "cpu")
    d = s.depth_u16[0].astype(np.float64) / 5000
    assert abs(d[24, 32] - 1.5) < 1e-3  # the box's near face
    assert abs(d[2, 2] - 3.0) < 1e-3  # the wall beside it
    pts = torch.tensor([[0.0, 0.0, 1.5], [0.0, 0.0, 1.7], [1.0, 1.0, 3.0], [0.0, 0.5, 1.7]],
                       dtype=torch.float64)
    dist = scene.surface_distance(mix, pts).tolist()
    assert dist[0] < 1e-12 and abs(dist[1] - 0.2) < 1e-12 and dist[2] < 1e-12
    assert abs(dist[3] - 0.3) < 1e-12


def test_random_boxes_are_fixed_geometry():
    mix = scene.load_mix("corridor_walk")
    lo, hi = scene.boxes(mix)
    lo2, hi2 = scene.boxes(scene.load_mix("corridor_walk"))
    assert torch.equal(lo, lo2) and torch.equal(hi, hi2)
    assert len(lo) == sum(g["count"] for g in mix["scene"]["random_boxes"])
    assert bool((hi > lo).all())


def test_an_orbit_is_data_alone():
    """The loop fixture's orbit (radius 0.4 m, a lap of 150 frames, facing
    along the tangent) as sines and a yaw rate: it comes back to its start
    after a lap, turning at 360 degrees per lap."""
    lap_s = 150 / 30.0
    mix = _bare({"planes": [[[0.0, 0.0, 3.0], [0.0, 0.0, -1.0]]]},
                {"position_sines": [[0, 0.4, 1 / lap_s, math.pi / 2], [2, 0.4, 1 / lap_s, 0.0]],
                 "start_deg": [0.0, 0.0, 0.0], "rotation_rates_dps": [-360.0 / lap_s, 0.0, 0.0]})
    rot, pos = scene.trajectory(mix, 151, 30.0)
    assert torch.allclose(pos[0], pos[150], atol=1e-9)
    assert torch.allclose(rot[0], rot[150], atol=1e-9)
    assert abs(pos[:, [0, 2]].norm(dim=-1) - 0.4).max() < 1e-12
    step = pos[1:] - pos[:-1]
    tangent = step / step.norm(dim=-1, keepdim=True)
    forward = 0.5 * (rot[1:, :, 2] + rot[:-1, :, 2])
    assert bool(((tangent * forward).sum(-1) > 0.999).all())
    rate = scene.motion_summary(mix, 151, 30.0)["rotation_dps"]
    assert abs(rate - 72.0) < 1e-6
