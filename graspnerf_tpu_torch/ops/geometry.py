"""Camera geometry, depth sampling and compositing of the volume and render
paths (graspnerf_tpu/ops/geometry.py). Given a `torch.Generator`,
`sample_depth` jitters its samples and `sample_fine_depth` draws its
quantiles at random (training), each through `draw_uniform`; without one
both are deterministic (eval).

Conventions: `poses` are world->camera [..,3,4] (OpenCV), `Ks` pinhole
intrinsics [..,3,3], pixel coords (x, y) in full-resolution units.
"""
from __future__ import annotations

from typing import Optional

import torch


def camera_centers(poses: torch.Tensor) -> torch.Tensor:
    """World-space camera centers -R^T t for poses [..,3,4] -> [..,3]."""
    rot = poses[..., :3, :3]
    t = poses[..., :3, 3]
    return -torch.einsum("...ji,...j->...i", rot, t)


def coords2rays(coords: torch.Tensor, poses: torch.Tensor, Ks: torch.Tensor):
    """Pixel coords [qn,rn,2] (x,y), poses [qn,3,4], Ks [qn,3,3] -> (ray
    centers [qn,rn,3], directions [qn,rn,3] of unit camera-frame depth)
    (geometry.py:39-54)."""
    qn, rn, _ = coords.shape
    centers = camera_centers(poses)
    hom = torch.cat([coords, coords.new_ones((qn, rn, 1))], -1)
    # inv_ex: the same inverse, without the error check's wait on the device
    Ks_inv = torch.linalg.inv_ex(Ks).inverse
    cam_dirs = torch.einsum("qij,qrj->qri", Ks_inv, hom)
    rot_t = poses[..., :3, :3].transpose(-1, -2)
    directions = torch.einsum("qij,qrj->qri", rot_t, cam_dirs)
    return centers[:, None, :].expand(qn, rn, 3), directions


def rays_at_depth(centers, directions, depth):
    """centers/directions [qn,rn,3], depth [qn,rn,dn] -> points [qn,rn,dn,3]
    (geometry.py:57-59)."""
    return centers[:, :, None, :] + directions[:, :, None, :] * depth[..., None]


def depth2points(coords, poses, Ks, depth):
    """-> (points [qn,rn,dn,3], unit view directions [qn,rn,dn,3], from the
    scene towards the camera) (geometry.py:62-74)."""
    centers, directions = coords2rays(coords, poses, Ks)
    pts = rays_at_depth(centers, directions, depth)
    que_dir = -directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    return pts, que_dir[:, :, None, :].expand(*depth.shape, 3)


def depth2dists(depth: torch.Tensor) -> torch.Tensor:
    """Forward differences along the last axis, 1e6 after the last sample
    (geometry.py:81-85)."""
    last = depth.new_full((*depth.shape[:-1], 1), 1e6)
    return torch.cat([depth[..., 1:] - depth[..., :-1], last], -1)


def from_inv_norm(u: torch.Tensor, depth_range: torch.Tensor) -> torch.Tensor:
    """Inverse of `to_inv_norm`, near/far from the first row of depth_range,
    as the JAX package does (geometry.py:102-105)."""
    near, far = -1.0 / depth_range[0, 0], -1.0 / depth_range[0, 1]
    return -1.0 / (u * (far - near) + near)


def depth2inv_dists(depth, depth_range):
    """Sample intervals in normalized inverse depth, [qn,rn,dn]
    (geometry.py:108-110)."""
    return depth2dists(to_inv_norm(depth, depth_range))


def draw_uniform(shape, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Uniform [0, 1) float32 of `shape` from `generator` (drawn on the
    generator's device), on `device`: the one random draw of the sampling
    functions, kept apart so that a test can hand in another library's."""
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def sample_depth(depth_range: torch.Tensor, rn: int, dn: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """dn depths per ray, evenly spaced in inverse depth from near to far,
    depth_range [qn,2] -> [qn,rn,dn] (geometry.py:113-131); with a
    generator the dn-2 inner ticks are jittered by up to half a step."""
    qn = depth_range.shape[0]
    near, far = depth_range[:, 0], depth_range[:, 1]
    interval = (1.0 / far - 1.0 / near) / (dn - 1)
    val = torch.arange(1, dn - 1, dtype=torch.float32, device=depth_range.device)
    val = val.expand(qn, rn, dn - 2)
    if generator is not None:
        val = val + (draw_uniform((qn, rn, dn - 2), generator,
                                  depth_range.device) - 0.5) * 0.999
    ticks = interval[:, None, None] * val
    diff = 1.0 / far - 1.0 / near
    ticks = torch.cat([ticks.new_zeros((qn, rn, 1)), ticks,
                       diff[:, None, None].expand(qn, rn, 1)], -1)
    return 1.0 / (1.0 / near[:, None, None] + ticks)


def sample_fine_depth(depth, hit_prob, depth_range, fdn: int,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Hierarchical resampling: fdn depths per ray at the evenly spaced
    quantiles (i + 0.5) / fdn of the per-ray hit-probability CDF, or at
    uniform random ones with a generator, in inverse depth.
    depth/hit_prob [qn,rn,dn] -> [qn,rn,fdn], unsorted (geometry.py:134-173;
    near/far from depth_range's first row, as there)."""
    near, far = -1.0 / depth_range[0, 0], -1.0 / depth_range[0, 1]
    depth_u = (-1.0 / depth - near) / (far - near)
    mid = (depth_u[..., 1:] + depth_u[..., :-1]) * 0.5
    bins = torch.cat([depth_u[..., :1], mid, depth_u[..., -1:]], -1)

    hit_prob = hit_prob + 1e-5
    pdf = hit_prob / torch.sum(hit_prob, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)

    if generator is None:
        u = (torch.arange(fdn, dtype=torch.float32, device=depth.device)
             + 0.5) / fdn
        u = u.expand(*cdf.shape[:-1], fdn).contiguous()
    else:
        u = draw_uniform((*cdf.shape[:-1], fdn), generator, depth.device)
    # cdf is non-decreasing, so this is the JAX package's count of the
    # entries <= u
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    fine_u = bins_b + t * (bins_a - bins_b)
    return -1.0 / (fine_u * (far - near) + near)


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


def near_far_bounds_ref(depth: torch.Tensor, interval: torch.Tensor,
                        depth_range: torch.Tensor):
    """Per-sample bounds in normalized inverse depth: bin i spans
    [d_i - I_{i-1}/2, d_i + I_i/2]. depth [V,qn,rn,dn], interval
    [1,qn,rn,dn], depth_range [V,2] (geometry.py:229-242)."""
    near_r = (-1.0 / depth_range[:, 0])[:, None, None, None]
    far_r = (-1.0 / depth_range[:, 1])[:, None, None, None]
    d = -1.0 / depth.clamp_min(1e-5)
    d = (d - near_r) / (far_r - near_r)
    half = interval * 0.5
    ext = torch.cat([half[..., :1], half], -1)
    return d - ext[..., :-1], d + ext[..., 1:]


def alpha2hit_prob(alpha: torch.Tensor) -> torch.Tensor:
    """alpha [...,dn] -> hit probability, alpha times the transmittance
    before each sample (geometry.py:213-217)."""
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


def composite(hit_prob: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """hit_prob [...,dn] x values [...,dn,c] -> [...,c] (geometry.py:220-222)."""
    return torch.sum(hit_prob[..., None] * values, -2)
