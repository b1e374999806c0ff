"""3D-3D point-cloud alignment RANSAC (host, numpy float64).

Counterpart of ``badslam_tpu/loop/ransac.py`` (the reference's OpenGV
RansacPointCloud, loop_detector.cc:299-360): sample 3 correspondences per
hypothesis, solve the closed-form rigid alignment (Horn, no scale), count
inliers by 3D distance, refine on the inlier set. All hypotheses are drawn
and scored at once; without a generator the draws come from
``default_rng(0)``, so the same inputs give the same hypotheses as the JAX
package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from badslam_torch.geometry import se3_np as s3


def rigid_align(a: np.ndarray, b: np.ndarray) -> s3.SE3:
    """Least-squares SE3 with b ≈ R a + t (Horn's method)."""
    mu_a = a.mean(axis=0)
    mu_b = b.mean(axis=0)
    U, _, Vt = np.linalg.svd((a - mu_a).T @ (b - mu_b))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    t = mu_b - R @ mu_a
    return s3.SE3(s3.matrix_to_quat(R), t)


def ransac_point_cloud_alignment(
    a: np.ndarray,                 # [N, 3] points in frame A
    b: np.ndarray,                 # [N, 3] corresponding points in frame B
    threshold: float = 0.05,       # inlier distance (m)
    max_iterations: int = 200,
    min_inliers: int = 10,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[Optional[s3.SE3], np.ndarray]:
    """Returns (B_T_A or None, inlier mask)."""
    n = a.shape[0]
    if n < 3:
        return None, np.zeros(n, bool)
    rng = rng or np.random.default_rng(0)

    B = max_iterations
    # kth=2 puts the 3 smallest keys in slots 0..2 (and stays legal at
    # the n == 3 minimum, where kth=3 would be out of range).
    idx = np.argpartition(rng.random((B, n)), 2, axis=1)[:, :3]  # [B,3]
    sa, sb = a[idx], b[idx]                                      # [B,3,3]
    # Degenerate (near-collinear) samples give unstable alignments.
    ok = np.linalg.norm(
        np.cross(sa[:, 1] - sa[:, 0], sa[:, 2] - sa[:, 0]), axis=-1) > 1e-8
    mu_a = sa.mean(axis=1, keepdims=True)                        # [B,1,3]
    mu_b = sb.mean(axis=1, keepdims=True)
    H = np.matmul((sa - mu_a).transpose(0, 2, 1), sb - mu_b)     # [B,3,3]
    U, _, Vt = np.linalg.svd(H)
    det = np.linalg.det(np.matmul(Vt.transpose(0, 2, 1),
                                  U.transpose(0, 2, 1)))
    S = np.broadcast_to(np.eye(3), (B, 3, 3)).copy()
    S[:, 2, 2] = np.sign(det)
    R = np.matmul(Vt.transpose(0, 2, 1), np.matmul(S, U.transpose(0, 2, 1)))
    t = mu_b[:, 0] - np.einsum("bij,bj->bi", R, mu_a[:, 0])      # [B,3]
    pred = np.einsum("bij,nj->bni", R, a) + t[:, None, :]        # [B,N,3]
    inl = np.linalg.norm(pred - b[None], axis=-1) < threshold    # [B,N]
    counts = np.where(ok, inl.sum(axis=1), -1)
    best = int(np.argmax(counts))
    best_count = int(counts[best])
    best_inliers = inl[best] if best_count > 0 else np.zeros(n, bool)

    if best_count < max(3, min_inliers):
        return None, best_inliers
    pose = rigid_align(a[best_inliers], b[best_inliers])
    pred = s3.transform_points(pose, a)
    inliers = np.linalg.norm(pred - b, axis=-1) < threshold
    if int(inliers.sum()) >= 3:
        pose = rigid_align(a[inliers], b[inliers])
    return pose, inliers
