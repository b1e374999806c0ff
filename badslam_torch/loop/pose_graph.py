"""SE3 pose-graph optimization: the host solver and the front end's solver.

Counterpart of ``badslam_tpu/loop/pose_graph.py`` (the reference's g2o
wrapper, pose_graph_optimizer.cc:69-131): one vertex per keyframe, an
odometry chain of edges from the current estimates plus the loop edge,
identity information, Gauss-Newton with right-multiplied updates
X <- X exp(d) (20 iterations in the reference). Edge residual
r = log(Z^-1 Xi^-1 Xj) for the measurement Z = Xi^-1 Xj, with Jacobians
taken at the identity increment.

Two solvers, as in the JAX package:

* ``optimize_pose_graph``: host float64, the fixed vertex eliminated, the
  sparse block normal equations solved by scipy's sparse LU.
* ``optimize_pose_graph_device``: what the front end's closure runs, in
  torch on the keyframe store's device: float32, a dense 6n x 6n system,
  vertex 0 held by a 1e4 prior, 1e-5 damping, 20 iterations, non-finite
  deltas zeroed, the chain measurements taken from the input poses (so a
  loop weight of 0 makes the solve a no-op up to rounding). The dense
  system is solved with ``torch.linalg.solve``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from badslam_torch.geometry import se3
from badslam_torch.geometry import se3_np as s3


class PoseGraphEdge:
    __slots__ = ("i", "j", "measurement", "weight")

    def __init__(self, i: int, j: int, measurement: s3.SE3, weight: float = 1.0):
        self.i = i
        self.j = j
        self.measurement = measurement  # Xi^-1 Xj
        self.weight = weight


def _adjoint(p: s3.SE3) -> np.ndarray:
    """SE3 adjoint [[R, [t]x R], [0, R]] for twist order [v, w]."""
    R = s3.quat_to_matrix(p.q)
    t = np.asarray(p.t, float)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[:3, 3:] = tx @ R
    A[3:, 3:] = R
    return A


def optimize_pose_graph(poses: List[s3.SE3], edges: Sequence[PoseGraphEdge],
                        fixed: int = 0, iterations: int = 20,
                        damping: float = 1e-6) -> List[s3.SE3]:
    """Gauss-Newton over global_T_frame vertices; returns updated poses."""
    n = len(poses)
    poses = list(poses)
    if n == 0:
        return poses

    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve

    # The fixed vertex is eliminated (delta_fixed = 0); the others pack
    # densely.
    var = np.full(n, -1, np.int64)
    var[np.arange(n) != fixed] = np.arange(n - 1)
    m = 6 * (n - 1)
    if m == 0:
        return poses
    br, bc = np.mgrid[0:6, 0:6]

    for _ in range(iterations):
        rows: List[np.ndarray] = []
        cols: List[np.ndarray] = []
        data: List[np.ndarray] = []
        b = np.zeros(m)
        for e in edges:
            xi, xj = poses[e.i], poses[e.j]
            rel = s3.mul(s3.inverse(xi), xj)
            r = s3.log(s3.mul(s3.inverse(e.measurement), rel))
            # d r / d dj ~ I, d r / d di ~ -Adj(rel^-1)
            Jj = np.eye(6)
            Ji = -_adjoint(s3.inverse(rel))
            w = e.weight
            for (a, Ja) in ((e.i, Ji), (e.j, Jj)):
                if var[a] < 0:
                    continue
                for (c, Jc) in ((e.i, Ji), (e.j, Jj)):
                    if var[c] < 0:
                        continue
                    rows.append(6 * var[a] + br.ravel())
                    cols.append(6 * var[c] + bc.ravel())
                    data.append((w * Ja.T @ Jc).ravel())
                b[6 * var[a]:6 * var[a] + 6] += w * Ja.T @ r
        if not rows:
            break
        H = sp.coo_matrix((np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))),
                          shape=(m, m)).tocsc() + damping * sp.eye(m, format="csc")
        try:
            delta = spsolve(H, -b)
        except RuntimeError:
            break
        if not np.all(np.isfinite(delta)):
            break
        for v in range(n):
            if var[v] >= 0:
                poses[v] = s3.mul(poses[v], s3.exp(delta[6 * var[v]:6 * var[v] + 6]))
        if np.linalg.norm(delta) < 1e-10:
            break
    return poses


def odometry_chain_edges(poses: List[s3.SE3]) -> List[PoseGraphEdge]:
    """The odometry chain from the current estimates
    (pose_graph_optimizer.cc:84-103)."""
    return [PoseGraphEdge(i, i + 1, s3.mul(s3.inverse(poses[i]), poses[i + 1]))
            for i in range(len(poses) - 1)]


def _adjoint_t(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Batched SE3 adjoint [[R, [t]x R], [0, R]] (twist order [v, w])."""
    R = se3.quat_to_matrix(q)                       # [..., 3, 3]
    zeros = torch.zeros_like(t[..., 0])
    tx = torch.stack([
        torch.stack([zeros, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], zeros, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], zeros], -1),
    ], -2)
    top = torch.cat([R, tx @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)            # [..., 6, 6]


def optimize_pose_graph_device(
    q: torch.Tensor,        # [n, 4] keyframe rotations in temporal order
    t: torch.Tensor,        # [n, 3]
    loop_a: int,            # loop edge source vertex (the matched keyframe)
    loop_b: int,            # loop edge target vertex (the current keyframe)
    loop_zq: torch.Tensor,  # [4] measurement Z = X_a^-1 X_b (matched_T_cur)
    loop_zt: torch.Tensor,  # [3]
    loop_weight: float = 1.0,
    iterations: int = 20,
):
    """Chain + loop-edge Gauss-Newton on the poses' device; returns the
    optimized (q, t)."""
    n = q.shape[0]
    dev = q.device
    chain_z = se3.mul(se3.inverse(se3.SE3(q[:-1], t[:-1])), se3.SE3(q[1:], t[1:]))
    ia = torch.cat([torch.arange(n - 1, device=dev),
                    torch.tensor([loop_a], device=dev)])
    ib = torch.cat([torch.arange(1, n, device=dev),
                    torch.tensor([loop_b], device=dev)])
    zq = torch.cat([chain_z.q, loop_zq.reshape(1, 4).to(q)])
    zt = torch.cat([chain_z.t, loop_zt.reshape(1, 3).to(t)])
    w = torch.ones(n, dtype=torch.float32, device=dev)
    w[-1] = loop_weight
    we = w[:, None, None]
    Z_inv = se3.inverse(se3.SE3(zq, zt))
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    damped = 1e-5 * torch.eye(6 * n, dtype=torch.float32, device=dev)

    cq, ct = q, t
    for _ in range(iterations):
        rel = se3.mul(se3.inverse(se3.SE3(cq[ia], ct[ia])), se3.SE3(cq[ib], ct[ib]))
        r = se3.log(se3.mul(Z_inv, rel))                    # [E, 6]
        inv_rel = se3.inverse(rel)
        Ji = -_adjoint_t(inv_rel.q, inv_rel.t)              # [E, 6, 6]
        JiT = Ji.transpose(-1, -2)
        H = torch.zeros((n, n, 6, 6), dtype=torch.float32, device=dev)
        H.index_put_((ia, ia), we * (JiT @ Ji), accumulate=True)
        H.index_put_((ia, ib), we * JiT, accumulate=True)
        H.index_put_((ib, ia), we * Ji, accumulate=True)
        H.index_put_((ib, ib), we * eye6, accumulate=True)
        bv = torch.zeros((n, 6), dtype=torch.float32, device=dev)
        bv.index_add_(0, ia, w[:, None] * (JiT @ r[..., None])[..., 0])
        bv.index_add_(0, ib, w[:, None] * r)
        # Gauge prior on vertex 0, plus damping.
        H[0, 0] += 1e4 * eye6
        Hd = H.permute(0, 2, 1, 3).reshape(6 * n, 6 * n) + damped
        delta = torch.linalg.solve(Hd, -bv.reshape(-1)).reshape(n, 6)
        delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
        upd = se3.mul(se3.SE3(cq, ct), se3.exp(delta))
        cq, ct = upd.q, upd.t
    return cq, ct
