"""A synthetic scene for the checks and tools on the card: cameras on a
hemisphere around the workspace, looking at its centre, with random images;
the planner's volume grid projected into them, which are the epipolar
gather's coordinates on the main path; query rays to render; and a seeded
training batch with labels."""
from __future__ import annotations

import numpy as np
import torch

from ..data import to_device
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


def train_coords(batch, samples: int = 40):
    """(xy [V,P,2], valid [V,P]) of a training batch's coarse pass (P =
    rays x samples): its query rays at `sample_depth`'s evenly spaced
    inverse depths, projected into the reference views, in the order
    `project_to_views` gathers them."""
    que, ref = batch["data"]["que"], batch["data"]["ref"]
    depth = geometry.sample_depth(que["depth_range"], que["coords"].shape[1],
                                  samples)
    pts, _ = geometry.depth2points(que["coords"], que["poses"], que["Ks"],
                                   depth)
    _, height, width, _ = ref["imgs"].shape
    xy, _, valid = geometry.project_points(pts.reshape(-1, 3), ref["poses"],
                                           ref["Ks"], height, width)
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


def training_batch(rng: np.random.RandomState, device, views: int = 6,
                   height: int = 288, width: int = 512, n_rays: int = 512,
                   res: int = 40, n_grasps: int = 32):
    """A single-scene training batch (`train.trainer`'s contract) of
    float32 / int64 tensors on `device`, seeded from rng: synthetic views;
    n_rays random pixels of view 0 as the query, with its image; as
    true_depth each view's depth to the plane z = 0 (camera-frame depth,
    clipped into its depth range); sdf_gt uniform in [-1, 1] with 20 % of
    the voxels at -1 (invalid); n_grasps random voxels with 0/1 labels,
    pairs of unit quaternions (xyzw) and widths in [0.5, 9] voxels."""
    images, poses, Ks, dr = synthetic_views(rng, views, height, width)
    que = query_rays(rng, images, poses, Ks, dr, n_rays)
    ys, xs = np.mgrid[:height, :width].astype(np.float64)
    pix = np.stack([xs, ys, np.ones_like(xs)], -1)               # h,w,3
    depth = []
    for pose, K, (near, far) in zip(poses, Ks, dr):
        R, t = pose[:, :3].astype(np.float64), pose[:, 3].astype(np.float64)
        center = -R.T @ t
        dirs = pix @ np.linalg.inv(K).T @ R                       # world, z_cam = 1
        with np.errstate(divide="ignore"):
            d = -center[2] / dirs[..., 2]
        depth.append(np.clip(np.where(d > 0, d, far), near, far))
    sdf_gt = rng.uniform(-1, 1, (res, res, res))
    sdf_gt[rng.rand(res, res, res) < 0.2] = -1.0
    q = rng.randn(n_grasps, 2, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    data = {"ref": {"imgs": images, "poses": poses, "Ks": Ks,
                    "depth_range": dr, "bbox3d_min": DEFAULT_BBOX_MIN},
            "que": que,
            "grasp_index": rng.randint(0, res, (n_grasps, 3))}
    batch = {"data": data,
             "true_depth": np.stack(depth)[..., None],
             "sdf_gt": sdf_gt,
             "grasp_label": rng.randint(0, 2, n_grasps).astype(np.float32),
             "grasp_rot": q,
             "grasp_width": rng.uniform(0.5, 9.0, n_grasps)}
    return to_device(batch, device)
