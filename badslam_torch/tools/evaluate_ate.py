"""Absolute trajectory error of a TUM-format trajectory.

Counterpart of the JAX package's ``tools/evaluate_ate.py``: associate an
estimated trajectory with ground truth by timestamp, align it (SE3 by
default, Sim3 with ``--align sim3``, none with ``--align none``) and report
the ATE RMSE with the mean, median and largest error after alignment, the
TUM benchmark's evaluate_ate protocol. Host numpy only.

    python -m badslam_torch.tools.evaluate_ate est.txt groundtruth.txt [--align sim3]

As a library: ``associate_and_evaluate(est_path, gt_path)``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from badslam_torch.synthetic import align_trajectory


def load_trajectory_host(path: str):
    """TUM file -> (timestamps [N], positions [N,3], quats wxyz [N,4])."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.replace(",", " ").split()]
            ts.append(v[0])
            pos.append(v[1:4])
            qx, qy, qz, qw = v[4:8]
            quat.append([qw, qx, qy, qz])
    return np.array(ts), np.array(pos), np.array(quat)


def associate(ts_a, ts_b, max_difference: float = 0.02):
    """Nearest-timestamp association (TUM associate.py protocol): index
    pairs (i, j) with |ts_a[i] - ts_b[j]| <= max_difference, each entry used
    at most once, greedily by time difference."""
    cand = []
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        d = abs(ts_b[j] - t)
        if d <= max_difference:
            cand.append((d, i, j))
    cand.sort()
    used_a, used_b, pairs = set(), set(), []
    for d, i, j in cand:
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        pairs.append((i, j))
    pairs.sort()
    return pairs


def evaluate(est_pos: np.ndarray, gt_pos: np.ndarray, align: str = "se3"):
    """ATE stats after alignment (Horn / Umeyama): rmse, mean, median, max,
    pairs and the Sim3 scale (1 otherwise)."""
    aligned, scale = align_trajectory(est_pos, gt_pos, align)
    err = np.linalg.norm(aligned - gt_pos, axis=-1)
    return {
        "rmse": float(np.sqrt(np.mean(np.sum((aligned - gt_pos) ** 2, axis=-1)))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "pairs": len(est_pos),
        "scale": scale,
    }


def associate_and_evaluate(est_path: str, gt_path: str, align: str = "se3",
                           max_difference: float = 0.02):
    ts_e, pos_e, _ = load_trajectory_host(est_path)
    ts_g, pos_g, _ = load_trajectory_host(gt_path)
    pairs = associate(ts_e, ts_g, max_difference)
    if not pairs:
        raise ValueError("no timestamp associations found")
    ei = [i for i, _ in pairs]
    gj = [j for _, j in pairs]
    return evaluate(pos_e[ei], pos_g[gj], align)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("estimated", help="estimated trajectory (TUM format)")
    p.add_argument("groundtruth", help="ground-truth trajectory (TUM format)")
    p.add_argument("--align", choices=("se3", "sim3", "none"), default="se3")
    p.add_argument("--max_difference", type=float, default=0.02,
                   help="max timestamp difference for association [s]")
    args = p.parse_args(argv)
    stats = associate_and_evaluate(args.estimated, args.groundtruth,
                                   args.align, args.max_difference)
    print(f"pairs:        {stats['pairs']}")
    print(f"ate rmse [m]: {stats['rmse']:.6f}")
    print(f"mean [m]:     {stats['mean']:.6f}")
    print(f"median [m]:   {stats['median']:.6f}")
    print(f"max [m]:      {stats['max']:.6f}")
    if args.align == "sim3":
        print(f"scale:        {stats['scale']:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
