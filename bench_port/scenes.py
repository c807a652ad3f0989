"""The benchmark's inputs, made from the seed: the dataset's camera rig and
seeded scenes for the planning and training mixes.

The rig is the source dataset's: 24 views on a radius-0.5 hemisphere
around the workspace centre (0, 0, 0.1), 6 azimuths at each of 4
elevations from 15 to 45 degrees, looking at the centre, z up; the vgn_syn
intrinsics (f 892.62, centre (639.5, 359.5) at 1280 x 720) scaled to the
image width. A scene's six reference views are one elevation's six
azimuths. Images are smooth seeded colour fields (a coarse random grid,
bilinearly upsampled, plus fine noise), made on the device in one call
and copied to the host. Every seed draws the same set of sizes: the pool
spreads its scenes evenly over the four elevations and only their order
and content follow the seed.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

CENTER = np.array([0.0, 0.0, 0.1])
RADIUS = 0.5
N_AZ, N_EL = 6, 4
BBOX_MIN = np.array([-0.15, -0.15, -0.0503], np.float32)


def hemisphere_poses() -> np.ndarray:
    """The 24 world->camera poses [24,3,4] (OpenCV axes), elevation-major."""
    poses = []
    for ei in range(N_EL):
        el = np.deg2rad(15 + 30 * ei / (N_EL - 1))
        for ai in range(N_AZ):
            az = 2 * np.pi * ai / N_AZ
            eye = CENTER + RADIUS * np.array([np.cos(az) * np.cos(el),
                                              np.sin(az) * np.cos(el),
                                              np.sin(el)])
            fwd = (CENTER - eye) / np.linalg.norm(CENTER - eye)
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= np.linalg.norm(right)
            R = np.stack([right, np.cross(fwd, right), fwd])
            poses.append(np.concatenate([R, (-R @ eye)[:, None]], 1))
    return np.stack(poses).astype(np.float32)


def intrinsics(width: int) -> np.ndarray:
    """vgn_syn's pinhole intrinsics at 1280 x 720, scaled to `width`."""
    K = np.array([[892.62, 0, 639.5], [0, 892.62, 359.5], [0, 0, 1]],
                 np.float32)
    K[:2] *= width / 1280.0
    return K


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def images(seed: int, n: int, h: int, w: int, device) -> np.ndarray:
    """n smooth seeded RGB images [n,h,w,3] in [0,1], float32, on the
    host."""
    g = torch.Generator(device=device).manual_seed(
        int(rng(seed, 1).integers(2 ** 62)))
    coarse = torch.rand(n, 3, 9, 16, generator=g, device=device)
    fine = torch.rand(n, 3, h, w, generator=g, device=device)
    img = F.interpolate(coarse, size=(h, w), mode="bilinear",
                        align_corners=True) * 0.85 + fine * 0.15
    return img.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def elevation_rows(seed: int, n: int) -> np.ndarray:
    """n elevation rows, as even a share of each of the 4 as n allows, in
    a seeded order."""
    return rng(seed, 2).permutation(np.arange(n) % N_EL)


def plan_pool(seed: int, scenes: int, views: int, h: int, w: int,
              depth_range, device) -> List[Dict[str, np.ndarray]]:
    """The planning calls' scenes: {images [V,h,w,3], extrinsics [V,3,4],
    Ks [V,3,3], depth_range [V,2]}, float32 on the host, as a robot hands
    them to the planner."""
    poses, K = hemisphere_poses(), intrinsics(w)
    imgs = images(seed, scenes * views, h, w, device)
    pool = []
    for s, row in enumerate(elevation_rows(seed, scenes)):
        ids = [row * N_AZ + (i * N_AZ) // views for i in range(views)]
        pool.append({"images": imgs[s * views:(s + 1) * views],
                     "extrinsics": poses[ids],
                     "Ks": np.tile(K[None], (views, 1, 1)),
                     "depth_range": np.tile(np.asarray(
                         [depth_range], np.float32), (views, 1))})
    return pool


def plane_depth(pose: np.ndarray, K: np.ndarray, h: int, w: int,
                near: float, far: float) -> np.ndarray:
    """Camera-frame depth [h,w] of the table plane z = 0, clipped to
    [near, far] (far where the pixel misses it)."""
    ys, xs = np.mgrid[:h, :w].astype(np.float64)
    pix = np.stack([xs, ys, np.ones_like(xs)], -1)
    R, t = pose[:, :3].astype(np.float64), pose[:, 3].astype(np.float64)
    eye = -R.T @ t
    dirs = pix @ np.linalg.inv(K).T @ R
    with np.errstate(divide="ignore", invalid="ignore"):
        d = -eye[2] / dirs[..., 2]
    return np.clip(np.where(d > 0, d, far), near, far).astype(np.float32)


def train_pool(seed: int, scenes: int, views: int, h: int, w: int,
               depth_range, rays: int, res: int, grasps: int,
               device) -> List[dict]:
    """The training job's scenes, each a single-scene batch with the keys,
    shapes and dtypes of the port's synthetic generator, as pinned CPU
    tensors: six reference views of one elevation, a query view of the
    24 with `rays` random pixels and its image, as true depth the table
    plane's, sdf_gt uniform in [-1, 1] with a fifth of the voxels -1
    (unobserved), `grasps` labelled voxels with a pair of unit quaternions
    and a width in [1.33, 9.33] voxels."""
    poses, K = hemisphere_poses(), intrinsics(w)
    near, far = depth_range
    imgs = images(seed, scenes * (views + 1), h, w, device)
    depth_cache: Dict[int, np.ndarray] = {}
    pool = []
    for s, row in enumerate(elevation_rows(seed, scenes)):
        r = rng(seed, 3, s)
        ids = [row * N_AZ + (i * N_AZ) // views for i in range(views)]
        que_id = int(r.integers(len(poses)))
        for i in ids:
            if i not in depth_cache:
                depth_cache[i] = plane_depth(poses[i], K, h, w, near, far)
        idx = r.integers(0, h * w, rays)
        coords = np.stack([idx % w, idx // w], -1).astype(np.float32)[None]
        sdf = r.uniform(-1, 1, (res,) * 3).astype(np.float32)
        sdf[r.random((res,) * 3) < 0.2] = -1.0
        q = r.standard_normal((grasps, 2, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        dr = np.asarray([depth_range], np.float32)
        im = imgs[s * (views + 1):(s + 1) * (views + 1)]
        tree = {
            "data": {
                "ref": {"imgs": im[:views], "poses": poses[ids],
                        "Ks": np.tile(K[None], (views, 1, 1)),
                        "depth_range": np.tile(dr, (views, 1)),
                        "bbox3d_min": BBOX_MIN},
                "que": {"imgs": im[views:], "coords": coords,
                        "poses": poses[que_id][None], "Ks": K[None],
                        "depth_range": dr},
                "grasp_index": r.integers(0, res, (grasps, 3)).astype(
                    np.int32)},
            "true_depth": np.stack([depth_cache[i] for i in ids])[..., None],
            "sdf_gt": sdf,
            "grasp_label": r.integers(0, 2, grasps).astype(np.float32),
            "grasp_rot": q.astype(np.float32),
            "grasp_width": r.uniform(1.33, 9.33, grasps).astype(np.float32)}
        pool.append(pinned(tree))
    return pool


def pinned(tree):
    """A tree of numpy arrays as CPU tensors, pinned where a card is."""
    if isinstance(tree, dict):
        return {k: pinned(v) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree))
    return t.pin_memory() if torch.cuda.is_available() else t


def on_device(tree, device):
    """The reference's copy of a pool tree on `device`: integers int64,
    the rest float32."""
    if isinstance(tree, dict):
        return {k: on_device(v, device) for k, v in tree.items()}
    t = torch.as_tensor(tree)
    return t.to(device, torch.int64 if not t.dtype.is_floating_point
                else torch.float32)


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s draws (fine samples, depth-loss pixels)."""
    return int(rng(seed, 4, step).integers(2 ** 62))
