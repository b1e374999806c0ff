"""Host-side (numpy float64) SE3 Lie math for the loop-closure stack.

Counterpart of ``badslam_tpu/geometry/se3_np.py``: loop detection, RANSAC,
the host pose graph and the host trajectory deformation are CPU subsystems,
as in the reference (loop_detector.cc, pose_graph_optimizer.cc,
trajectory_deformation.cc).

Quaternions are wxyz, poses are (q, t) rotating column vectors:
x_out = R(q) x + t.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class SE3(NamedTuple):
    q: np.ndarray  # [4] wxyz unit quaternion
    t: np.ndarray  # [3]


def identity() -> SE3:
    return SE3(np.array([1.0, 0, 0, 0]), np.zeros(3))


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """Shepperd's method; returns wxyz with w >= 0."""
    m = R
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s,
                      (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s,
                      (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                      (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                      0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                      (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def mul(a: SE3, b: SE3) -> SE3:
    q = quat_mul(np.asarray(a.q, float), np.asarray(b.q, float))
    q /= np.linalg.norm(q)
    return SE3(q, quat_to_matrix(a.q) @ np.asarray(b.t, float)
               + np.asarray(a.t, float))


def inverse(p: SE3) -> SE3:
    q = np.asarray(p.q, float)
    qi = np.array([q[0], -q[1], -q[2], -q[3]])
    return SE3(qi, -(quat_to_matrix(qi) @ np.asarray(p.t, float)))


def exp(twist: np.ndarray) -> SE3:
    """se3 exp; twist = [v (3), w (3)]."""
    v = np.asarray(twist[:3], float)
    w = np.asarray(twist[3:], float)
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return SE3(np.array([1.0, 0, 0, 0]), v)
    axis = w / theta
    half = theta / 2.0
    q = np.concatenate([[np.cos(half)], np.sin(half) * axis])
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / theta
    V = (np.eye(3) + (1 - np.cos(theta)) / theta * K
         + (theta - np.sin(theta)) / theta * (K @ K))
    return SE3(q, V @ v)


def log(p: SE3) -> np.ndarray:
    q = np.asarray(p.q, float)
    if q[0] < 0:
        q = -q
    w_clamped = min(1.0, q[0])
    theta = 2.0 * np.arccos(w_clamped)
    s = np.sqrt(max(0.0, 1.0 - w_clamped * w_clamped))
    if s < 1e-12 or theta < 1e-12:
        w = 2.0 * q[1:]
        return np.concatenate([np.asarray(p.t, float), w])
    axis = q[1:] / s
    w = theta * axis
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / theta
    V = (np.eye(3) + (1 - np.cos(theta)) / theta * K
         + (theta - np.sin(theta)) / theta * (K @ K))
    v = np.linalg.solve(V, np.asarray(p.t, float))
    return np.concatenate([v, w])


def slerp(qa: np.ndarray, qb: np.ndarray, f: float) -> np.ndarray:
    qa = np.asarray(qa, float)
    qb = np.asarray(qb, float)
    d = float(qa @ qb)
    if d < 0:
        qb = -qb
        d = -d
    if d > 0.9995:
        out = (1 - f) * qa + f * qb
        return out / np.linalg.norm(out)
    theta = np.arccos(min(1.0, d))
    return (np.sin((1 - f) * theta) * qa + np.sin(f * theta) * qb) / np.sin(theta)


def from_device(pose) -> SE3:
    """A torch SE3 (any device) as a host float64 SE3; reads the device."""
    return SE3(pose.q.detach().cpu().numpy().astype(float),
               pose.t.detach().cpu().numpy().astype(float))


def transform_points(p: SE3, pts: np.ndarray) -> np.ndarray:
    return pts @ quat_to_matrix(p.q).T + np.asarray(p.t, float)
