"""A synthetic scene for the checks and tools on the card: cameras on a
hemisphere around the workspace, looking at its centre, with random images;
the planner's volume grid projected into them, which are the epipolar
gather's coordinates on the main path; and query rays to render."""
from __future__ import annotations

import numpy as np
import torch

from ..detect.planner import DEFAULT_BBOX_MIN
from ..models.renderer import volume_query_points
from ..ops import geometry


def synthetic_views(rng: np.random.RandomState, views: int = 6,
                    height: int = 288, width: int = 512):
    """(images [V,h,w,3], world->cam poses [V,3,4], Ks [V,3,3], depth
    ranges [V,2]) as float32 numpy: random images, the planner's default
    depth range, the reference camera's focal length scaled to the width."""
    center = np.array([0.0, 0.0, 0.1])
    f = 892.62 * width / 1280.0
    K = np.array([[f, 0, (width - 1) / 2], [0, f, (height - 1) / 2],
                  [0, 0, 1]], np.float32)
    poses = []
    for i in range(views):
        az, el = 2 * np.pi * i / views, np.deg2rad(40)
        eye = center + 0.5 * np.array([np.cos(az) * np.cos(el),
                                       np.sin(az) * np.cos(el), np.sin(el)])
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        poses.append(np.concatenate([R, (-R @ eye)[:, None]], 1))
    imgs = rng.rand(views, height, width, 3).astype(np.float32)
    dr = np.tile(np.array([[0.2, 0.8]], np.float32), (views, 1))
    return (imgs, np.stack(poses).astype(np.float32),
            np.tile(K[None], (views, 1, 1)), dr)


def volume_coords(poses: torch.Tensor, Ks: torch.Tensor, height: int,
                  width: int, res: int = 40, size: float = 0.3,
                  bbox_min=DEFAULT_BBOX_MIN):
    """(xy [V,res^3,2], valid [V,res^3]) of the planner's volume grid in
    each view, in the order `sample_volume` gathers them."""
    bbox = torch.as_tensor(np.asarray(bbox_min, np.float32),
                           device=poses.device)
    pts = volume_query_points(res, size, bbox).reshape(-1, 3)
    xy, _, valid = geometry.project_points(pts, poses, Ks, height, width)
    return xy.contiguous(), valid


def query_rays(rng: np.random.RandomState, images, poses, Ks, depth_range,
               n_rays: int = 4096, view: int = 0):
    """The renderer's `que` dict (float32 numpy): n_rays random pixels of
    reference view `view`, with that view's image, pose, intrinsics and
    depth range, as the JAX package's render benchmark picks them
    (bench.py:222-227)."""
    _, height, width, _ = images.shape
    idx = rng.randint(0, height * width, n_rays)
    coords = np.stack([idx % width, idx // width], -1).astype(np.float32)
    pick = slice(view, view + 1)
    return {"coords": coords[None], "poses": poses[pick], "Ks": Ks[pick],
            "depth_range": depth_range[pick], "imgs": images[pick]}
