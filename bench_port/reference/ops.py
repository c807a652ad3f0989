"""Camera geometry, sampling, bilinear fetches, compositing and the volume
filters of the reference, in float32. Poses are world->camera [..,3,4]
(OpenCV), intrinsics [..,3,3], pixel coordinates (x, y) in full-resolution
units; feature maps channels-last."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


# ------------------------------------------------------------- cameras
def camera_centers(poses):
    return -torch.einsum("...ji,...j->...i", poses[..., :3, :3],
                         poses[..., :3, 3])


def depth2points(coords, poses, Ks, depth):
    """coords [qn,rn,2], depth [qn,rn,dn] -> (points [qn,rn,dn,3], unit
    directions towards the camera [qn,rn,dn,3])."""
    qn, rn, _ = coords.shape
    hom = torch.cat([coords, coords.new_ones((qn, rn, 1))], -1)
    cam = torch.einsum("qij,qrj->qri", torch.linalg.inv(Ks), hom)
    dirs = torch.einsum("qij,qrj->qri", poses[..., :3, :3].transpose(-1, -2),
                        cam)
    pts = (camera_centers(poses)[:, None, None, :]
           + dirs[:, :, None, :] * depth[..., None])
    que_dir = -dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return pts, que_dir[:, :, None, :].expand(*depth.shape, 3)


def project_points(pts, poses, Ks, h: int, w: int):
    """pts [P,3] -> (xy [V,P,2], safe depth [V,P], valid [V,P])."""
    KRt = torch.einsum("vij,vjk->vik", Ks, poses)
    cam = torch.einsum("vik,pk->vpi", KRt[..., :3], pts) + KRt[..., 3][:, None]
    depth = cam[..., 2]
    bad = depth.abs() < 1e-4
    depth = torch.where(bad, torch.full_like(depth, 1e-3), depth)
    xy = cam[..., :2] / depth[..., None]
    inside = ((xy[..., 0] >= -0.5) & (xy[..., 0] < w - 0.5)
              & (xy[..., 1] >= -0.5) & (xy[..., 1] < h - 0.5))
    return xy, depth, ~bad & inside


def view_directions(pts, poses):
    d = pts[None] - camera_centers(poses)[:, None]
    return -d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-5)


# ------------------------------------------------------------ sampling
def depth2dists(depth):
    last = depth.new_full((*depth.shape[:-1], 1), 1e6)
    return torch.cat([depth[..., 1:] - depth[..., :-1], last], -1)


def to_inv_norm(depth, depth_range):
    shape = (-1,) + (1,) * (depth.dim() - 1)
    near = (-1.0 / depth_range[:, 0]).reshape(shape)
    far = (-1.0 / depth_range[:, 1]).reshape(shape)
    return (-1.0 / depth - near) / (far - near)


def sample_depth(depth_range, rn: int, dn: int):
    """dn depths a ray, evenly spaced in inverse depth -> [qn,rn,dn]."""
    qn = depth_range.shape[0]
    near, far = depth_range[:, 0], depth_range[:, 1]
    step = (1.0 / far - 1.0 / near) / (dn - 1)
    val = torch.arange(1, dn - 1, dtype=torch.float32,
                       device=depth_range.device).expand(qn, rn, dn - 2)
    ticks = step[:, None, None] * val
    diff = 1.0 / far - 1.0 / near
    ticks = torch.cat([ticks.new_zeros((qn, rn, 1)), ticks,
                       diff[:, None, None].expand(qn, rn, 1)], -1)
    return 1.0 / (1.0 / near[:, None, None] + ticks)


def sample_fine_depth(depth, hit_prob, depth_range, fdn: int,
                      generator=None):
    """fdn depths a ray at quantiles of the hit-probability CDF in inverse
    depth: (i + 0.5) / fdn, or uniform draws from `generator` (on its own
    device). Unsorted."""
    near, far = -1.0 / depth_range[0, 0], -1.0 / depth_range[0, 1]
    u_depth = (-1.0 / depth - near) / (far - near)
    mid = (u_depth[..., 1:] + u_depth[..., :-1]) * 0.5
    bins = torch.cat([u_depth[..., :1], mid, u_depth[..., -1:]], -1)
    hit_prob = hit_prob + 1e-5
    cdf = torch.cumsum(hit_prob / hit_prob.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    shape = (*cdf.shape[:-1], fdn)
    if generator is None:
        u = ((torch.arange(fdn, dtype=torch.float32, device=depth.device)
              + 0.5) / fdn).expand(shape).contiguous()
    else:
        u = torch.rand(shape, generator=generator,
                       device=generator.device).to(depth.device)
    inds = torch.searchsorted(cdf, u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_b, bins_a = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    fine = bins_b + (u - cdf_b) / denom * (bins_a - bins_b)
    return -1.0 / (fine * (far - near) + near)


def near_far(depth, depth_range, interval=None, fixed: float = 0.01):
    """Each sample's bin in normalised inverse depth: a fixed width around
    it (volume queries, interval None) or half the intervals to its
    neighbours (rays; interval [1,qn,rn,dn])."""
    near_r = (-1.0 / depth_range[:, 0])[:, None, None, None]
    far_r = (-1.0 / depth_range[:, 1])[:, None, None, None]
    d = ((-1.0 / depth.clamp_min(1e-5)) - near_r) / (far_r - near_r)
    if interval is None:
        return d - fixed / 2, d + fixed / 2
    half = interval * 0.5
    ext = torch.cat([half[..., :1], half], -1)
    return d - ext[..., :-1], d + ext[..., 1:]


def alpha2hit_prob(alpha):
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


def composite(hit_prob, values):
    return torch.sum(hit_prob[..., None] * values, -2)


# ---------------------------------------------------------- bilinear fetch
def grid_sample_2d(feats, px, py, border: bool):
    """feats [B,H,W,C] at pixel coordinates px/py [B,N] -> [B,N,C]; taps off
    the map clamped (border) or zero."""
    B, H, W, C = feats.shape
    flat = feats.reshape(B, H * W, C)
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = (px - x0)[..., None], (py - y0)[..., None]
    x0, y0 = x0.long(), y0.long()

    def tap(xi, yi):
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = flat.gather(1, idx[..., None].expand(-1, -1, C))
        if not border:
            ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            v = v * ok[..., None].to(v.dtype)
        return v

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


def fetch(feats, points, h: int, w: int, border: bool = True,
          align_corners=None):
    """feats [B,fh,fw,C] at points [B,N,2] given in h x w pixels; aligned
    corners when the map is full-resolution unless told otherwise."""
    _, fh, fw, _ = feats.shape
    if align_corners is None:
        align_corners = fh == h and fw == w
    xn = points[..., 0] / (w - 1) * 2 - 1
    yn = points[..., 1] / (h - 1) * 2 - 1
    if align_corners:
        px, py = (xn + 1) * 0.5 * (fw - 1), (yn + 1) * 0.5 * (fh - 1)
    else:
        px, py = ((xn + 1) * fw - 1) * 0.5, ((yn + 1) * fh - 1) * 0.5
    return grid_sample_2d(feats, px, py, border)


def fetch_masked(feats, points, mask, h: int, w: int):
    return fetch(feats, points, h, w) * mask[..., None].to(feats.dtype)


def resize_nearest_3d(x, n: int):
    """Nearest resize of x [...,D,H,W] to n^3, source index floor(i*in/n)."""
    for dim in (-3, -2, -1):
        n_in = x.shape[dim]
        idx = [math.floor(i * (n_in / n)) for i in range(n)]
        x = x.index_select(dim, torch.tensor(idx, device=x.device))
    return x


def grid_points(res: int, size: float, device):
    """Voxel centres [res^3,3], x-major."""
    ax = torch.arange(res, dtype=torch.float32, device=device)
    g = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    return ((g + 0.5) * (size / res)).reshape(-1, 3)


# ------------------------------------------------------- volume filters
def gaussian_filter_3d(vol, sigma: float = 1.0, truncate: float = 4.0):
    """scipy.ndimage.gaussian_filter(mode='nearest') of vol [D,H,W]."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 / sigma ** 2 * x ** 2)
    k = torch.from_numpy((k / k.sum()).astype(np.float32)).to(vol.device)
    out = vol[None, None]
    for ax in range(3):
        shape = [1, 1, 1, 1, 1]
        shape[2 + ax] = k.numel()
        pad = [0] * 6
        pad[2 * (2 - ax)] = pad[2 * (2 - ax) + 1] = radius
        out = F.conv3d(F.pad(out, pad, mode="replicate"), k.reshape(shape))
    return out[0, 0]


def binary_dilation_masked(x, mask, iterations: int = 2):
    """scipy.ndimage.binary_dilation with the 3D cross, zero borders, and
    voxels outside mask kept as they are."""
    for _ in range(iterations):
        p = F.pad(x.float(), (1, 1, 1, 1, 1, 1))
        nb = torch.stack([p[:-2, 1:-1, 1:-1], p[2:, 1:-1, 1:-1],
                          p[1:-1, :-2, 1:-1], p[1:-1, 2:, 1:-1],
                          p[1:-1, 1:-1, :-2], p[1:-1, 1:-1, 2:],
                          p[1:-1, 1:-1, 1:-1]]).amax(0)
        x = x | ((nb > 0) & mask)
    return x


def window(i: int, n: int, size: int = 4):
    """The indices that scipy's maximum_filter(size, mode='reflect') reads
    at i along an axis of n: [i - size//2, i + size - 1 - size//2] folded
    back into the axis."""
    lo = size // 2
    return slice(max(0, i - lo), min(n, i + size - lo))


def maximum_filter_3d(vol, size: int = 4):
    """scipy.ndimage.maximum_filter(size, mode='reflect') of vol [D,H,W]."""
    lo, hi = size // 2, size - 1 - size // 2
    for dim in range(3):
        n = vol.shape[dim]
        idx = np.concatenate([np.arange(lo)[::-1], np.arange(n),
                              n - 1 - np.arange(hi)])
        vol = vol.index_select(dim, torch.from_numpy(idx).to(vol.device))
    return F.max_pool3d(vol[None, None], size, stride=1)[0, 0]
