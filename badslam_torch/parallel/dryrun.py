"""A dry run of every multi-device BA mode on tiny shapes.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``:

    python -m badslam_torch.parallel.dryrun [n_devices]      # CPU mesh
    dryrun_multichip(4, devices=["cuda:0"] * 4)              # 4 shards, 1 card

It runs (1) keyframe-sharded pose optimization, (2) surfel-sharded
geometry optimization, (3) the psummed single-pose Gauss-Newton, (4) the
integrated BA (``config.n_devices``, planes replicated) and (5) the
plane-streamed BA (a budget of 0 MB), asserting that streaming engaged and
that every shard holds K/D plane sets, and returns what each produced.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from badslam_torch import synthetic
from badslam_torch.ba.scheme import DirectBA
from badslam_torch.config import BadSlamConfig
from badslam_torch.geometry import se3
from badslam_torch.mapping import surfels as sf
from badslam_torch.mapping.keyframes import KeyframeStack
from badslam_torch.ops.preprocess import preprocess_frame
from badslam_torch.parallel import sharded
from badslam_torch.parallel.mesh import make_mesh


def _frame(cam, device):
    scene = synthetic.random_plane_scene(np.random.default_rng(3), 3)
    depth, inten = synthetic.render_scene(cam, scene, synthetic.pose())
    depth_u16 = np.clip(depth * 5000.0, 0, 65535).astype(np.int32)
    gray = np.clip(inten * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return preprocess_frame(
        cam, torch.from_numpy(depth_u16).to(device),
        torch.from_numpy(np.stack([gray] * 3, axis=-1)).to(device),
        a=torch.zeros((), device=device),
        cfactor=torch.zeros((cam.height // 4, cam.width // 4), device=device),
        raw_to_float_depth=1.0 / 5000.0)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The five modes over a mesh of `n_devices` shards on the CPU, or on
    the explicit `devices` (their first holds the global state)."""
    mesh = make_mesh(n_devices, "cpu", devices)
    n = mesh.size
    dev = mesh.primary
    cam = synthetic.default_camera(32, 32)
    f = _frame(cam, dev)

    # A tiny map (capacity divisible by n) from the frame; n keyframes.
    cap = 128 * n
    ident = se3.identity(dev)
    kstack = KeyframeStack(*(x[None].expand(n, -1, -1).contiguous() for x in
                             (f.depth, f.nx, f.ny, f.radius2, f.intensity)),
                           ident.q[None].expand(n, -1).contiguous(),
                           ident.t[None].expand(n, -1).contiguous(),
                           torch.ones(n, dtype=torch.bool, device=dev))
    smap, _ = sf.create_surfels_for_keyframe(
        sf.empty_map(cap, dev), cam, ident.q, ident.t, f.depth, f.nx, f.ny,
        f.radius2, f.intensity, kstack.rows(slice(0, 1)), 1, 40.0, 4,
        filter_new_surfels=False)
    smap = smap._replace(active=smap.valid)
    out = {"mesh": str(mesh), "surfels": int(smap.count)}

    # (1) keyframe-sharded pose optimization.
    poses = sharded.optimize_keyframe_poses_sharded(mesh, smap, cam, kstack,
                                                    max_iterations=2)
    out["poses_finite"] = bool(torch.isfinite(poses.t).all())
    # (2) surfel-sharded geometry optimization.
    geom = sharded.optimize_geometry_sharded(mesh, smap, cam, kstack)
    out["geometry_finite"] = bool(torch.isfinite(geom.pos[geom.valid]).all())
    # (3) the single-pose Gauss-Newton with psummed H/b.
    q, t = sharded.estimate_pose_sharded(mesh, smap, cam, ident.q, ident.t,
                                         f.depth, f.nx, f.ny, f.intensity,
                                         max_iterations=2)
    out["pose_gn_finite"] = bool(torch.isfinite(t).all())

    # (4) the integrated BA and (5) the plane-streamed BA.
    for mode, budget in (("integrated", 2048.0), ("streamed", 0.0)):
        cfg = BadSlamConfig(max_surfel_count=cap, n_devices=n, num_scales=1,
                            plane_replication_budget_mb=budget,
                            keyframe_bucket_base=8 if 8 % n == 0 else n)
        ba = DirectBA(cam, cfg, surfel_capacity=cap, device=dev, mesh=mesh)
        ba.add_keyframe(f, ident, 0)
        ba.create_surfels_for_keyframe(0, filter_new_surfels=False)
        ba.add_keyframe(f, se3.SE3(ident.q, ident.t + 0.002), 1)
        iterations = ba.bundle_adjustment(max_iterations=2)
        if mode == "streamed":
            kl = ba.keyframes.capacity // n
            if not ba._streaming:
                raise AssertionError("plane-streamed mode did not engage")
            held = [ba._planes.keyframes_held(i) for i in range(n)]
            if held != [kl] * n:
                raise AssertionError(f"shards hold {held} plane sets, not {kl} each")
        out[mode] = {"iterations": iterations, "surfels": ba.surfel_count,
                     "finite": bool(torch.isfinite(ba.keyframes.t).all())}
    return out


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8))
