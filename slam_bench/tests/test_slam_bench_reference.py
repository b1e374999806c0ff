"""The reference against the program's own plain path on the CPU, where
the program runs the same arithmetic (no K1, no K2, the host loop): equal
to the last bit. And the map check on maps whose answer is known."""

import math

import numpy as np
import pytest
import torch

from slam_bench import check, scene
from slam_bench.reference import geometry as se3
from slam_bench.tests.helpers import tiny_cell


@pytest.mark.parametrize("mix,frames", [("corridor_walk", (1, 4, 9)), ("desk_hover", (2, 5))])
def test_reference_tracks_as_the_program_on_the_cpu(mix, frames):
    from badslam_torch.config import BadSlamConfig
    from badslam_torch.geometry.camera import PinholeCamera
    from badslam_torch.ops.preprocess import preprocess_frame
    from badslam_torch.ops.pyramid import build_pyramid
    from badslam_torch.tracking.pairwise import track_frame_pairwise

    cell = tiny_cell(mix)
    cfg, c = cell["config"], cell["config"]["camera"]
    seq = scene.render(c, cell["mix"], 10, 30.0, 9, cfg["raw_to_float_depth"], "cpu")
    s = cfg["settings"]
    pcfg = BadSlamConfig(**s)
    cam = PinholeCamera(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], width=c["width"],
                        height=c["height"])
    cams = tuple(cam.pyramid_level(i) for i in range(s["num_scales"]))
    a = torch.zeros(())
    cf = torch.zeros(((c["height"] - 1) // 4 + 1, (c["width"] - 1) // 4 + 1))

    def port_pyramid(i):
        f = preprocess_frame(cam, torch.from_numpy(seq.depth_u16[i].astype(np.int32)),
                             torch.from_numpy(seq.color_u8[i]), max_depth=pcfg.max_depth,
                             a=a, cfactor=cf, raw_to_float_depth=cfg["raw_to_float_depth"])
        return build_pyramid(f.depth, f.nx, f.ny, f.intensity, s["num_scales"])

    ref = check.Reference(cfg, "cpu")
    base_p, base_r = port_pyramid(0), ref.pyramid(seq.depth_u16[0], seq.color_u8[0])
    for lp, lr in zip(base_p, base_r):
        for x, y in zip(lp, lr):
            assert torch.equal(x, y)
    ident = se3.identity("cpu")
    for i in frames:
        got = track_frame_pairwise(cams, base_p, port_pyramid(i), ident.q, ident.t,
                                   ident.q, ident.t)
        want = ref.track(base_r, ref.pyramid(seq.depth_u16[i], seq.color_u8[i]), ident,
                         ident, False)
        assert torch.equal(got.q, want.q) and torch.equal(got.t, want.t)


def test_rotation_angle():
    q = torch.tensor([0.9, 0.1, -0.3, 0.2], dtype=torch.float64)
    q = q / q.norm()
    assert check.rotation_angle(q, q) < 1e-15
    rz = torch.tensor([math.cos(0.005), 0.0, 0.0, math.sin(0.005)], dtype=torch.float64)
    assert abs(check.rotation_angle(q, se3.quat_mul(q, rz)) - 0.01) < 1e-12
    assert abs(check.rotation_angle(q, -q)) < 1e-12


def test_map_miss_of_known_maps():
    """Surfels on the corridor's true surfaces seen from the true pose
    explain the frame; an empty map or one moved by 0.3 m across the corridor does not."""
    cell = tiny_cell("corridor_walk")
    cfg = cell["config"]
    mix = dict(cell["mix"], sensor=dict(cell["mix"]["sensor"], depth_noise=0.0,
                                        depth_bias_quadratic=0.0))
    seq = scene.render(cfg["camera"], mix, 1, 30.0, 3, cfg["raw_to_float_depth"], "cpu")
    ref = check.Reference(cfg, "cpu")
    c = cfg["camera"]
    d = seq.depth_u16[0].astype(np.float64) * cfg["raw_to_float_depth"]
    ys, xs = np.nonzero((d > 0) & (d <= 3.0))
    z = d[ys, xs]
    pts = np.stack([(xs + 0.5 - c["cx"]) / c["fx"] * z, (ys + 0.5 - c["cy"]) / c["fy"] * z, z], -1)
    rot = se3.quat_to_matrix(torch.tensor(seq.gt_q[0])).numpy()
    world = pts @ rot.T + seq.gt_t[0]
    pose = {0: (seq.gt_q[0], seq.gt_t[0])}
    lim = cell["limits"]
    args = (lim["cell_px"], lim["tau_m"], lim["tau_quad"])
    assert check.map_miss(ref, seq, pose, world, [0], *args) < 1.0
    assert check.map_miss(ref, seq, pose, np.zeros((0, 3)), [0], *args) == 100.0
    assert check.map_miss(ref, seq, pose, world + [0.3, 0.3, 0.0], [0], *args) > 50.0


def test_surfel_noise_reads_the_spread_across_a_plane():
    """Surfels on the corridor's left wall (away from its boxes), offset
    by a smooth bias plus noise of a known spread: the reading is the
    noise's spread, not the bias."""
    mix = {"scene": {"planes": [[[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]]]}}
    gen = torch.Generator().manual_seed(3)
    y = torch.rand(40000, generator=gen, dtype=torch.float64) * 2.0 - 1.0
    z = torch.rand(40000, generator=gen, dtype=torch.float64) * 3.0 + 0.5
    for sigma in (0.0005, 0.002):
        x = -1.0 + 0.004 * z * z + sigma * torch.randn(40000, generator=gen, dtype=torch.float64)
        got = check.surfel_noise(mix, torch.stack([x, y, z], -1).numpy(), 0.05, "cpu")
        assert abs(got - 1e3 * sigma) < 0.1 * 1e3 * sigma, (sigma, got)


def test_kf_drift_is_blind_to_scale_and_sees_a_moved_keyframe():
    seq = scene.render({"width": 8, "height": 6, "fx": 7.0, "fy": 7.0, "cx": 4.0, "cy": 3.0},
                       scene.load_mix("corridor_walk"), 120, 30.0, 1, 1 / 5000, "cpu")
    frames = list(range(0, 120, 10))
    gt = {f: (seq.gt_q[f], seq.gt_t[f]) for f in frames}
    assert check.kf_drift(seq, gt, frames) < 1e-9
    # The whole trajectory scaled by 1.005 about its first keyframe.
    scaled = {f: (q, seq.gt_t[0] + 1.005 * (t - seq.gt_t[0])) for f, (q, t) in gt.items()}
    assert check.kf_drift(seq, scaled, frames) < 1e-6
    moved = dict(gt)
    moved[60] = (gt[60][0], gt[60][1] + np.array([0.001, 0.0, 0.0]))
    assert 0.9 < check.kf_drift(seq, moved, frames) < 1.1
