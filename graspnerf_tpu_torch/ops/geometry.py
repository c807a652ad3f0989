"""Camera geometry of the volume path (graspnerf_tpu/ops/geometry.py).

Conventions: `poses` are world->camera [..,3,4] (OpenCV), `Ks` pinhole
intrinsics [..,3,3], pixel coords (x, y) in full-resolution units.
"""
from __future__ import annotations

import torch


def camera_centers(poses: torch.Tensor) -> torch.Tensor:
    """World-space camera centers -R^T t for poses [..,3,4] -> [..,3]."""
    rot = poses[..., :3, :3]
    t = poses[..., :3, 3]
    return -torch.einsum("...ji,...j->...i", rot, t)


def project_points(pts: torch.Tensor, poses: torch.Tensor, Ks: torch.Tensor,
                   h: int, w: int):
    """pts [P,3], poses [V,3,4], Ks [V,3,3] -> (xy [V,P,2], depth [V,P],
    valid [V,P] bool). Depth is the safe depth (1e-3 where |depth| < 1e-4);
    valid = in front of the camera and inside [-0.5, size-0.5)."""
    KRt = torch.einsum("vij,vjk->vik", Ks, poses)
    cam = torch.einsum("vik,pk->vpi", KRt[..., :3], pts) + KRt[..., 3][:, None, :]
    depth = cam[..., 2]
    depth_invalid = depth.abs() < 1e-4
    safe_depth = torch.where(depth_invalid, torch.full_like(depth, 1e-3), depth)
    xy = cam[..., :2] / safe_depth[..., None]
    inside = ((xy[..., 0] >= -0.5) & (xy[..., 0] < w - 0.5)
              & (xy[..., 1] >= -0.5) & (xy[..., 1] < h - 0.5))
    return xy, safe_depth, (~depth_invalid) & inside


def view_directions(pts: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """Unit direction from each point towards each camera. [V,P,3]."""
    d = pts[None, :, :] - camera_centers(poses)[:, None, :]
    return -d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-5)


def to_inv_norm(depth: torch.Tensor, depth_range: torch.Tensor) -> torch.Tensor:
    """Metric depth [q,...] -> normalized inverse depth in [0,1] per row of
    depth_range [q,2]."""
    shape = (-1,) + (1,) * (depth.dim() - 1)
    near = (-1.0 / depth_range[:, 0]).reshape(shape)
    far = (-1.0 / depth_range[:, 1]).reshape(shape)
    return (-1.0 / depth - near) / (far - near)


def near_far_bounds_fixed(depth: torch.Tensor, depth_range: torch.Tensor,
                          fixed_val: float = 0.01):
    """Fixed-width inverse-depth bounds around each projected sample.
    depth [V,qn,rn,dn], depth_range [V,2]."""
    near_r = (-1.0 / depth_range[:, 0])[:, None, None, None]
    far_r = (-1.0 / depth_range[:, 1])[:, None, None, None]
    d = -1.0 / depth.clamp_min(1e-5)
    d = (d - near_r) / (far_r - near_r)
    return d - fixed_val / 2, d + fixed_val / 2
