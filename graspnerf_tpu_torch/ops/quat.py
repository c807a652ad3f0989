"""Rotations with quaternions xyzw (graspnerf_tpu/ops/quat.py): torch
helpers of the grasp loss's diagnostics, and the numpy functions of the
simulator's transforms."""
from __future__ import annotations

import math

import numpy as np
import torch


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..,4] xyzw (normalised here) -> rotation matrix
    [..,3,3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    xw, yw, zw = x * w, y * w, z * w
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - zw), 2 * (xz + yw),
        2 * (xy + zw), 1 - 2 * (xx + zz), 2 * (yz - xw),
        2 * (xz - yw), 2 * (yz + xw), 1 - 2 * (xx + yy)], -1)
    return m.reshape(*q.shape[:-1], 3, 3)


def geodesic_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle in radians between rotation matrices [..,3,3], its cosine
    clipped to [-1 + 1e-6, 1 - 1e-6]."""
    m = torch.einsum("...ij,...kj->...ik", R1, R2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1) / 2
    return torch.arccos(torch.clamp(cos, -1 + 1e-6, 1 - 1e-6))


def rot_error_deg_symmetric(q_pred: torch.Tensor,
                            q_gt_pair: torch.Tensor) -> torch.Tensor:
    """Least geodesic error in degrees of q_pred [n,4] against either of the
    two gripper-symmetric ground-truth quaternions q_gt_pair [n,2,4]."""
    Rp = quat_to_matrix(q_pred)
    e0 = geodesic_distance(quat_to_matrix(q_gt_pair[:, 0]), Rp)
    e1 = geodesic_distance(quat_to_matrix(q_gt_pair[:, 1]), Rp)
    return torch.minimum(e0, e1) * (180.0 / math.pi)


# numpy, for the simulator's rigid transforms (sim/transform.py), in the
# operation order of graspnerf_tpu/ops/quat.py:18-131 so that poses are
# bit-equal to the JAX package's

def normalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_multiply(q1, q2):
    """Hamilton product, xyzw: the rotation q1 after q2 (scipy's r1 * r2)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], -1)


def quat_conjugate(q):
    return np.concatenate([-q[..., :3], q[..., 3:]], -1)


def quat_to_matrix_np(q):
    """numpy counterpart of `quat_to_matrix`: quaternion [..,4] xyzw
    (normalised here) -> rotation matrix [..,3,3]."""
    q = normalize(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    xw, yw, zw = x * w, y * w, z * w
    m = np.stack([
        1 - 2 * (yy + zz), 2 * (xy - zw), 2 * (xz + yw),
        2 * (xy + zw), 1 - 2 * (xx + zz), 2 * (yz - xw),
        2 * (xz - yw), 2 * (yz + xw), 1 - 2 * (xx + yy),
    ], -1)
    return m.reshape(*q.shape[:-1], 3, 3)


def matrix_to_quat(m):
    """Rotation matrix [..,3,3] -> unit quaternion [..,4] xyzw with w >= 0
    (Shepperd's method: all four candidates, the best-conditioned kept)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return np.sqrt(np.maximum(x, 1e-12))

    qw = 0.5 * safe_sqrt(1 + tr)
    qx = 0.5 * safe_sqrt(1 + m00 - m11 - m22)
    qy = 0.5 * safe_sqrt(1 - m00 + m11 - m22)
    qz = 0.5 * safe_sqrt(1 - m00 - m11 + m22)
    c0 = np.stack([qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx),
                   (m21 - m12) / (4 * qx)], -1)
    c1 = np.stack([(m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy),
                   (m02 - m20) / (4 * qy)], -1)
    c2 = np.stack([(m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz,
                   (m10 - m01) / (4 * qz)], -1)
    c3 = np.stack([(m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                   (m10 - m01) / (4 * qw), qw], -1)
    cands = np.stack([c0, c1, c2, c3], -2)                     # ..,4,4
    scores = np.stack([1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                       1 - m00 - m11 + m22, 1 + tr], -1)
    idx = np.argmax(scores, -1)
    q = np.take_along_axis(cands, idx[..., None, None].repeat(4, -1),
                           -2)[..., 0, :]
    q = normalize(q)
    return np.where(q[..., 3:] < 0, -q, q)


def rotate_vector(q, v):
    """Rotate vectors v [..,3] by quaternions q [..,4]."""
    u = q[..., :3]
    w = q[..., 3:]
    uv = np.cross(u, v)
    return v + 2 * (w * uv + np.cross(u, uv))


def from_axis_angle(axis, angle):
    """axis [..,3] (unit), angle [..] -> quaternion xyzw."""
    axis = np.asarray(axis)
    angle = np.asarray(angle, dtype=axis.dtype)
    s = np.sin(angle / 2)
    c = np.cos(angle / 2)
    return np.concatenate([axis * s[..., None], c[..., None]], -1)
