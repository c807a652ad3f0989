"""TSDF query grid (graspnerf_tpu/ops/tsdf.py:26-53)."""
from __future__ import annotations

import torch

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
