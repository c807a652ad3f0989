"""TSDF query grid and depth-image TSDF fusion (graspnerf_tpu/ops/tsdf.py:26-95).

The fusion is the classical projective TSDF: per view, each voxel centre is
projected to its nearest pixel, its signed distance to the observed depth is
truncated at four voxels, and observed voxels average their truncated values
with weight 1 (what Open3D's UniformTSDFVolume computes). It runs on the
card unless `device` says otherwise; the data pipeline's workers pass
device="cpu".
"""
from __future__ import annotations

import torch

from ..device import resolve_device

RESOLUTION = 40
VOLUME_SIZE = 0.3


def grid_points(resolution: int = RESOLUTION, volume_size: float = VOLUME_SIZE,
                device=None) -> torch.Tensor:
    """Voxel centers in volume-local coords, [res^3, 3] in x-major order
    (index = (x*res + y)*res + z)."""
    voxel = volume_size / resolution
    ax = torch.arange(resolution, dtype=torch.float32, device=device)
    g = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    return ((g + 0.5) * voxel).reshape(-1, 3)


def integrate_tsdf(depth_imgs, Ks, extrinsics, size: float = VOLUME_SIZE,
                   resolution: int = RESOLUTION, device=None):
    """Fuse depth images into a TSDF volume.

    depth_imgs [n,h,w] metric depth (0 = no return), Ks [n,3,3], extrinsics
    [n,4,4] world(volume-local)->camera transforms; numpy arrays or tensors.
    Returns float32 tensors on `device` (None: the card, raising without
    one; `device.resolve_device`): tsdf [res,res,res] in [-1,1] (1 =
    free space at or beyond the truncation, 0 = surface) and weights
    [res,res,res]; unobserved voxels have weight 0.
    """
    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    depth_imgs, Ks, extrinsics = t(depth_imgs), t(Ks), t(extrinsics)
    sdf_trunc = 4 * (size / resolution)
    pts = grid_points(resolution, size, device)                  # P,3
    n, h, w = depth_imgs.shape
    # the same operation order as JAX: the 3x3 product, then the translation
    cam = (torch.einsum("nij,pj->npi", extrinsics[:, :3, :3], pts)
           + extrinsics[:, None, :3, 3])                         # n,P,3
    z = cam[..., 2]
    uv = torch.einsum("nij,npj->npi", Ks, cam)
    zs = torch.where(z == 0, torch.ones_like(z), z)
    ui = torch.round(uv[..., 0] / zs).to(torch.int64)   # half to even, as jnp
    vi = torch.round(uv[..., 1] / zs).to(torch.int64)
    inside = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (z > 0)
    flat = vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1)
    d = torch.gather(depth_imgs.reshape(n, -1), 1, flat)
    sdf = d - z
    observed = inside & (d > 0) & (sdf >= -sdf_trunc)
    wgt = observed.to(torch.float32)
    tsdf_sum = (torch.clamp(sdf / sdf_trunc, -1.0, 1.0) * wgt).sum(0)
    w_sum = wgt.sum(0)
    tsdf = torch.where(w_sum > 0, tsdf_sum / torch.clamp(w_sum, min=1.0),
                       torch.zeros_like(w_sum))
    shape = (resolution,) * 3
    return tsdf.reshape(shape), w_sum.reshape(shape)
