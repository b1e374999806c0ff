"""Full SLAM state snapshot: save / load (checkpoint and resume), and the
calibration text files.

Counterpart of ``badslam_tpu/io/state.py`` (the reference's state IO,
io.h:38-77). A snapshot is one compressed ``.npz`` with the JAX package's
keys, dtypes and magic string, so that either package resumes the other's:
the config as JSON, the camera, every frame pose, the motion history, the
BA counters and the parallel-BA queue, the depth-deformation parameters,
the keyframes (planes, poses, validity, activation, covisibility, depth
range, BA counters), the surfel map and the loop-closure count. The JAX
package sizes the keyframe store and the surfel map on a power-of-two
ladder and the port does not:
`load_state` takes any capacity that holds the snapshot's contents. With
loop detection on, the live keyframes' features are registered again in
temporal order from the dataset's frames, built as the front end builds them
(gray, and the nearest remap of a distorted source), through the detection
thread's queue when there is one.
"""

from __future__ import annotations

import dataclasses
import json
import numpy as np
import torch

MAGIC = "BADSLAM_TPU"
VERSION = 1

# Keyframe fields, with the snapshot dtype of each.
_KF_FIELDS = {
    "depth": np.float32, "raw_depth": np.float32, "nx": np.float32,
    "ny": np.float32, "radius2": np.float32, "intensity": np.float32,
    "rgb": np.uint8, "q": np.float32, "t": np.float32, "valid": bool,
    "activation": np.int32, "covis": bool, "min_depth": np.float32,
    "max_depth": np.float32, "last_active_iter": np.int32,
    "last_covis_iter": np.int32,
}
_SF_FIELDS = {
    "pos": np.float32, "normal": np.float32, "radius2": np.float32,
    "color": np.float32, "desc": np.float32, "valid": bool, "active": bool,
}


def _np(x, dtype) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x, dtype)


def save_state(slam, path: str) -> None:
    """Snapshot a frontend.BadSlam to `path` (.npz)."""
    ks = slam.direct_ba.keyframes
    m = slam.direct_ba.surfels
    cam = slam.cam
    n = min(slam._hist_n, 3)  # the newest n rows of the motion history
    params = slam.direct_ba.depth_params
    data = dict(
        magic=MAGIC, version=VERSION,
        config_json=json.dumps(dataclasses.asdict(slam.config)),
        cam=np.array([cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height],
                     np.float64),
        frame_poses_q=_np(slam.traj_q, np.float32),
        frame_poses_t=_np(slam.traj_t, np.float32),
        frame_has_pose=np.asarray(slam.has_pose, bool),
        base_kf_id=np.int64(-1 if slam.base_kf_id is None else slam.base_kf_id),
        base_kf_hist_q=_np(slam._hist_q[3 - n:], np.float32),
        base_kf_hist_t=_np(slam._hist_t[3 - n:], np.float32),
        last_frame_index=np.int64(slam.last_frame_index),
        ba_counter=np.int64(slam.bundle_adjustment_counter),
        queued_ba_iterations=np.int64(slam.queued_ba_iterations),
        loop_closure_count=np.int64(slam.loop_closure_count),
        depth_a=_np(params.a, np.float32),
        depth_cfactor=_np(params.cfactor, np.float32),
        ba_iteration_count=np.int64(slam.direct_ba.ba_iteration_count),
        kf_count=np.int64(ks.count),
        kf_frame_indices=np.array(ks.frame_indices, np.int64),
        kf_free_slots=np.array(ks.free_slots, np.int64),
    )
    if ks.count > 0:
        for name, dtype in _KF_FIELDS.items():
            data[f"kf_{name}"] = _np(getattr(ks, name), dtype)
    for name, dtype in _SF_FIELDS.items():
        data[f"sf_{name}"] = _np(getattr(m, name), dtype)
    data["sf_count"] = np.int32(int(m.count))
    with open(path, "wb") as f:
        np.savez_compressed(f, **data)


def load_state(path: str, video, device: torch.device | str = "cuda"):
    """Restore a frontend.BadSlam from a snapshot of either package on
    `device`; processing resumes at `last_frame_index + 1`. The snapshot's
    config is checked by `check_supported`."""
    from badslam_torch.ba.intrinsics_opt import DepthParams
    from badslam_torch.config import BadSlamConfig
    from badslam_torch.frontend import BadSlam, check_supported
    from badslam_torch.geometry.camera import PinholeCamera
    from badslam_torch.mapping.keyframes import KeyframeStore
    from badslam_torch.ops.pyramid import build_pyramid

    z = np.load(path, allow_pickle=False)
    if str(z["magic"]) != MAGIC:
        raise ValueError(f"{path}: not a badslam state file")
    names = {f.name for f in dataclasses.fields(BadSlamConfig)}
    config = BadSlamConfig(**{k: v for k, v in json.loads(str(z["config_json"])).items()
                              if k in names})
    check_supported(config)
    slam = BadSlam(config, video, device)
    c = z["cam"]
    cam = PinholeCamera(fx=float(c[0]), fy=float(c[1]), cx=float(c[2]),
                        cy=float(c[3]), width=int(c[4]), height=int(c[5]))
    if (cam.width, cam.height) != (slam.cam.width, slam.cam.height):
        raise ValueError(f"{path}: snapshot camera {cam.width}x{cam.height} does "
                         f"not match the dataset's {slam.cam.width}x{slam.cam.height}")
    # The snapshot's intrinsics, which self-calibration may have changed,
    # replace the dataset's everywhere the camera is held.
    slam.cam = cam
    slam.cams_pyramid = tuple(cam.pyramid_level(i) for i in range(config.num_scales))
    slam.direct_ba.cam = cam
    slam.direct_ba.keyframes.cam = cam
    dev = slam.device

    def tensor(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(dev)

    # Frame state, padded or trimmed to the video's length.
    pq, pt, has = z["frame_poses_q"], z["frame_poses_t"], z["frame_has_pose"]
    m = min(slam.traj_q.shape[0], pq.shape[0])
    slam.traj_q[:m] = tensor(pq[:m])
    slam.traj_t[:m] = tensor(pt[:m])
    slam.has_pose[:m] = has[:m]
    slam.last_frame_index = int(z["last_frame_index"])
    slam.bundle_adjustment_counter = int(z["ba_counter"])
    slam.loop_closure_count = int(z["loop_closure_count"])
    if "queued_ba_iterations" in z.files:
        slam.queued_ba_iterations = int(z["queued_ba_iterations"])
    hq, ht = z["base_kf_hist_q"][-3:], z["base_kf_hist_t"][-3:]
    n = hq.shape[0]
    slam._hist_q[3 - n:] = tensor(hq)
    slam._hist_t[3 - n:] = tensor(ht)
    slam._hist_n = z["base_kf_hist_q"].shape[0]

    ba = slam.direct_ba
    ba.ba_iteration_count = int(z["ba_iteration_count"])
    ba.depth_params = DepthParams(a=tensor(z["depth_a"], torch.float32),
                                  cfactor=tensor(z["depth_cfactor"], torch.float32))

    k = int(z["kf_count"])
    if k > 0:
        capacity = config.keyframe_bucket_base
        while capacity < k:
            capacity *= 2
        ks = KeyframeStore(slam.cam, dev, capacity=capacity)
        for name in _KF_FIELDS:
            if name == "covis":
                ks.covis[:k, :k] = tensor(z["kf_covis"][:k, :k])
            elif f"kf_{name}" in z.files:
                dst = getattr(ks, name)
                dst[:k] = tensor(z[f"kf_{name}"][:k], dst.dtype)
        if "kf_rgb" not in z.files:  # older snapshots: gray from intensity
            g = torch.clamp(ks.intensity[:k] * 255.0 + 0.5, 0, 255).to(torch.uint8)
            ks.rgb[:k] = torch.stack([g, g, g], dim=-1)
        ks.count = k
        ks.frame_indices = [int(v) for v in z["kf_frame_indices"][:k]]
        ks.free_slots = ([int(v) for v in z["kf_free_slots"]]
                         if "kf_free_slots" in z.files else [])
        ba.keyframes = ks

    # The map is compact at frame boundaries: its valid surfels fill the
    # prefix [0, count), which must fit the port's capacity.
    smap = ba.surfels
    n = min(smap.capacity, z["sf_valid"].shape[0])
    if z["sf_valid"][n:].any():
        raise ValueError(f"{path}: the snapshot's surfels do not fit the map's "
                         f"capacity {smap.capacity}")
    fields = {}
    for name in _SF_FIELDS:
        dst = getattr(smap, name).clone()
        dst[:n] = tensor(z[f"sf_{name}"][:n], dst.dtype)
        fields[name] = dst
    ba.surfels = smap._replace(
        count=torch.tensor(int(z["sf_count"]), dtype=torch.int64, device=dev),
        **fields)
    # The surfel bound is not in the snapshot (in neither package): the
    # next BA call's bucket must still hold the restored surfels.
    ba._creation_bound = max(ba._creation_bound, int(z["sf_count"]) + 64)

    base = int(z["base_kf_id"])
    if base >= 0:
        ks = ba.keyframes
        slam.base_kf_id = base
        slam.base_kf_global_T_frame = ks.pose(base)
        slam.base_kf_pyramid = build_pyramid(
            ks.depth[base], ks.nx[base], ks.ny[base], ks.intensity[base],
            config.num_scales, gradmag=config.use_gradmag)
        if slam.loop_detector is not None:
            for slot in ks.live_slots_in_time_order():
                fi = ks.frame_indices[slot]
                slam.register_keyframe_features(slot, fi)
                video.clear_frame(fi)
    return slam


def save_calibration(cam, depth_params, path_prefix: str) -> None:
    """Three text files (io.h:66-72): depth intrinsics, color intrinsics,
    deformation parameters."""
    for kind in ("depth", "color"):
        with open(f"{path_prefix}_{kind}_intrinsics.txt", "w") as f:
            f.write(f"{cam.width} {cam.height} {float(cam.fx)} {float(cam.fy)} "
                    f"{float(cam.cx)} {float(cam.cy)}\n")
    cf = _np(depth_params.cfactor, np.float32)
    with open(path_prefix + "_deformation.txt", "w") as f:
        f.write(f"{float(_np(depth_params.a, np.float32))} {cf.shape[1]} {cf.shape[0]}\n")
        np.savetxt(f, cf)


def load_calibration(path_prefix: str):
    """Returns ((fx, fy, cx, cy, w, h), a, cfactor)."""
    with open(path_prefix + "_depth_intrinsics.txt") as f:
        w, h, fx, fy, cx, cy = (float(v) for v in f.readline().split())
    with open(path_prefix + "_deformation.txt") as f:
        a, wc, hc = (float(v) for v in f.readline().split())
        cfactor = np.loadtxt(f).reshape(int(hc), int(wc))
    return (fx, fy, cx, cy, int(w), int(h)), a, cfactor
