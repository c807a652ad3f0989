"""Rotation helpers of the grasp loss's diagnostics, quaternions xyzw
(graspnerf_tpu/ops/quat.py:41-121)."""
from __future__ import annotations

import math

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
