"""Volumetric filters of the grasp post-processing (graspnerf_tpu/ops/image.py),
with scipy.ndimage's semantics: kernel radii, border modes and even-size
window origins."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage's truncated, normalised Gaussian kernel."""
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return (phi / phi.sum()).astype(np.float32)


def gaussian_filter_3d(vol: torch.Tensor, sigma: float = 1.0,
                       truncate: float = 4.0) -> torch.Tensor:
    """Separable 3D Gaussian blur of vol [D,H,W] with border mode 'nearest'
    (edge replicate), as scipy.ndimage.gaussian_filter(mode='nearest')."""
    radius = int(truncate * sigma + 0.5)
    k = torch.from_numpy(_gaussian_kernel1d(sigma, radius)).to(vol.device)
    x = vol[None, None]
    for ax in range(3):
        shape = [1, 1, 1, 1, 1]
        shape[2 + ax] = k.numel()
        pad = [0, 0, 0, 0, 0, 0]
        pad[2 * (2 - ax)] = pad[2 * (2 - ax) + 1] = radius
        x = F.conv3d(F.pad(x, pad, mode="replicate"), k.reshape(shape))
    return x[0, 0]


def binary_dilation_masked(x: torch.Tensor, mask: torch.Tensor,
                           iterations: int = 2) -> torch.Tensor:
    """scipy.ndimage.binary_dilation with the 3D cross structuring element,
    zero borders and a mask outside which voxels keep their state.
    x, mask: bool [D,H,W]."""
    D, H, W = x.shape
    for _ in range(iterations):
        p = F.pad(x.to(torch.float32), (1, 1, 1, 1, 1, 1))
        c = p[1:-1, 1:-1, 1:-1]
        nb = torch.stack([p[:-2, 1:-1, 1:-1], p[2:, 1:-1, 1:-1],
                          p[1:-1, :-2, 1:-1], p[1:-1, 2:, 1:-1],
                          p[1:-1, 1:-1, :-2], p[1:-1, 1:-1, 2:], c]).amax(0)
        x = x | ((nb > 0) & mask)
    return x


def maximum_filter_3d(vol: torch.Tensor, size: int = 4) -> torch.Tensor:
    """scipy.ndimage.maximum_filter(size=size) of vol [D,H,W], border mode
    'reflect' (numpy's 'symmetric': the edge sample repeats). For even sizes
    the window at i spans [i - size//2, i + size//2 - 1]."""
    lo = size // 2
    hi = size - 1 - lo
    for dim in range(3):
        n = vol.shape[dim]
        idx = np.concatenate([np.arange(lo)[::-1], np.arange(n),
                              n - 1 - np.arange(hi)])
        vol = vol.index_select(dim, torch.from_numpy(idx).to(vol.device))
    return F.max_pool3d(vol[None, None], size, stride=1)[0, 0]
