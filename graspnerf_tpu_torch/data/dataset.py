"""File-backed training dataset (ref: src/nr/dataset/train_dataset.py:73-425
GeneralRendererDataset) producing the same batch contract as the synthetic
generator. A copy of graspnerf_tpu/data/dataset.py: importing the JAX
package imports jax.

Per sample (matching the reference's live vgn path): pick a scene, choose 6
equally-spaced reference views of the 24 hemisphere poses anchored at a
random target + a query offset 1..3 (augment.get_ref_que_ids, ref :204-209,
:226), the 5%-probability depth-range aug (ref :271-279), margin-style
consistent depth range (ref :320-334), reflect-pad-to-/32 (ref
imgs_info.py:60-75, ref_pad_interval 32), and foreground-biased ray sampling
(512 rays, half on object pixels — ref :303-318). The reference feeds the
CLEAN depth as true_depth for vgn (no noise — train_dataset.py:383), so
depth_noise defaults to off; the patch-offset noise (ref :29-42) is available
via augment.add_depth_offset.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .database import VGNSynDatabase, discover_scenes, TOTAL_VIEWS
from .augment import (get_ref_que_ids, random_change_depth_range,
                      consistent_depth_range, pad_imgs_to_interval)


def select_ref_views(n_views: int, que_id: int, rng, mode: str = "hard",
                     total: int = TOTAL_VIEWS):
    """6 equally-spaced views; 'hard' avoids the 8 azimuth-nearest to the
    query (ref train_dataset.py:195-209)."""
    az = lambda i: i % 6  # noqa: E731  (6 azimuths x 4 elevations)
    start = rng.randint(0, total)
    ids = [(start + k * total // n_views) % total for k in range(n_views)]
    if mode == "hard":
        que_az = az(que_id)
        far = [i for i in range(total)
               if min((az(i) - que_az) % 6, (que_az - az(i)) % 6) >= 2]
        if len(far) >= n_views:
            rng.shuffle(far)
            step = max(len(far) // n_views, 1)
            ids = sorted(far)[::step][:n_views]
            if len(ids) < n_views:
                ids += far[:n_views - len(ids)]
    return ids


def add_depth_noise(depth, rng, depth_length: float = 0.6,
                    small_offset_prob: float = 0.5,
                    global_noise_prob: float = 0.5):
    """Sensor-style depth noise (ref train_dataset.py:281-301 add_depth_noise,
    gso branch): a rectangular-patch offset (the 'small offset' variant,
    region 0.1-0.2, offset 0.01-0.05, local jitter 0.005 — ref :296) plus
    uniform global noise of ±0.005·depth_length (ref :297-299). Off by
    default for vgn, whose reference path feeds clean depth."""
    if depth is None:
        return depth
    depth = depth.astype(np.float32).copy()
    mask = depth > 0
    if mask.any() and rng.random() < small_offset_prob:
        from .augment import add_depth_offset
        add_depth_offset(depth, mask, 0.1, 0.2, 0.01, 0.05, 0.005,
                         depth_length, rng)
    if rng.random() < global_noise_prob:
        depth += rng.uniform(-0.005, 0.005,
                             depth.shape).astype(np.float32) * depth_length
    return np.where(mask, depth, 0.0).astype(np.float32)


def fg_biased_coords(mask, n_rays: int, rng, fg_ratio: float = 0.5):
    """Half the rays on foreground pixels (ref :303-318 + get_coords_mask)."""
    h, w = mask.shape if mask is not None else (None, None)
    if mask is None:
        raise ValueError("mask required")
    flat = mask.reshape(-1)
    fg_idx = np.flatnonzero(flat)
    n_fg = min(int(n_rays * fg_ratio), len(fg_idx))
    sel = []
    if n_fg:
        sel.append(fg_idx[rng.randint(0, len(fg_idx), n_fg)])
    sel.append(rng.randint(0, flat.size, n_rays - n_fg))
    idx = np.concatenate(sel)
    return np.stack([idx % w, idx // w], -1).astype(np.float32)


class VGNSynDataset:
    """Infinite sampler over discovered scenes → trainer batches."""

    def __init__(self, root: str, sdf_root: Optional[str] = None,
                 grasp_root: Optional[str] = None, n_views: int = 6,
                 n_rays: int = 512, n_grasps: int = 32, seed: int = 0,
                 scene_types=("pile", "packed"), split: str = "train",
                 depth_noise: bool = False, aug_depth_range: bool = True,
                 pad_interval: int = 32,
                 scenes: Optional[List[str]] = None):
        """`scenes` overrides directory discovery with an explicit scene-dir
        list (train/val held-out splits — ref asset.py's train/val scene
        lists)."""
        self.scenes = (list(scenes) if scenes is not None
                       else discover_scenes(root, scene_types, split))
        if not self.scenes:
            raise FileNotFoundError(f"no scenes under {root}")
        self.sdf_root = sdf_root
        self.grasp_root = grasp_root
        self.n_views, self.n_rays, self.n_grasps = n_views, n_rays, n_grasps
        self.rng = np.random.RandomState(seed)
        self.depth_noise = depth_noise
        self.aug_depth_range = aug_depth_range
        self.pad_interval = pad_interval
        # per-scene database cache: the reference eagerly loads every grasp
        # CSV at import (ref asset.py:41-49); constructing a fresh database
        # per draw re-reads camera_pose.npy and re-parses the CSV every
        # sample. Databases memoize their own sdf/grasp parses, so one
        # instance per scene makes those one-time costs.
        self._db_cache = {}

    def _db(self, scene_dir: str) -> VGNSynDatabase:
        db = self._db_cache.get(scene_dir)
        if db is None:
            import os
            sid = os.path.basename(scene_dir)
            sdf = (f"{self.sdf_root}/{sid}.npz" if self.sdf_root else None)
            csv = (f"{self.grasp_root}/{sid}.csv" if self.grasp_root else None)
            db = VGNSynDatabase(scene_dir, sdf, csv)
            self._db_cache[scene_dir] = db
        return db

    def sample(self):
        rng = self.rng
        db = self._db(self.scenes[rng.randint(0, len(self.scenes))])
        ref_ids, que_id = get_ref_que_ids(rng, min(TOTAL_VIEWS, len(db)),
                                          self.n_views)

        views = db.get_images(list(ref_ids) + [que_id])
        imgs, que_img = views[:-1], views[-1:]
        poses = np.stack([db.get_pose(i) for i in ref_ids])
        Ks = np.stack([db.get_K(i) for i in ref_ids])
        dr = np.stack([db.get_depth_range(i) for i in ref_ids])
        que_dr = db.get_depth_range(que_id)[None]

        # depth-range aug + consistent range across ref+que (ref :271-279,
        # :320-334, applied to the concatenated ranges at :354-362)
        dr_all = np.concatenate([dr, que_dr], 0)
        if self.aug_depth_range:
            dr_all = random_change_depth_range(dr_all, rng)
        dr, que_dr = consistent_depth_range(dr_all[:-1], dr_all[-1:])

        depths = [db.get_depth(i) for i in ref_ids]
        if all(d is not None for d in depths):
            depths = [add_depth_noise(d, rng) if self.depth_noise else d
                      for d in depths]
            true_depth = np.stack(depths)[..., None].astype(np.float32)
        else:
            true_depth = None

        # reflect-pad ref images (+aligned depth) to /pad_interval
        padded = pad_imgs_to_interval(
            {"imgs": imgs, "true_depth": true_depth},
            self.pad_interval)
        imgs, true_depth = padded["imgs"], padded.get("true_depth")

        mask = db.get_mask(que_id)
        if mask is None:
            mask = np.ones(que_img.shape[1:3], bool)
        coords = fg_biased_coords(mask, self.n_rays, rng)[None]

        sdf_gt = db.get_sdf()
        if sdf_gt is None:
            sdf_gt = -np.ones((40, 40, 40), np.float32)
        gi = db.get_grasp_info()
        if gi is None:
            idx = rng.randint(0, 40, (self.n_grasps, 3)).astype(np.int32)
            label = np.zeros(self.n_grasps, np.float32)
            rot = np.tile(np.array([0, 0, 0, 1], np.float32), (self.n_grasps, 2, 1))
            width = np.zeros(self.n_grasps, np.float32)
        else:
            idx_all, label_all, rot_all, width_all = gi
            pick = rng.randint(0, len(label_all), self.n_grasps)
            idx, label = idx_all[pick], label_all[pick]
            rot, width = rot_all[pick], width_all[pick]

        batch = {
            "data": {
                "ref": {"imgs": imgs, "poses": poses, "Ks": Ks,
                        "depth_range": dr,
                        "bbox3d_min": np.array([-0.15, -0.15, -0.05],
                                               np.float32)},
                "que": {"imgs": que_img, "coords": coords,
                        "poses": db.get_pose(que_id)[None],
                        "Ks": db.get_K(que_id)[None],
                        "depth_range": que_dr},
                "grasp_index": idx,
            },
            "sdf_gt": sdf_gt,
            "grasp_label": label, "grasp_rot": rot, "grasp_width": width,
        }
        if true_depth is not None:
            batch["true_depth"] = true_depth
        return batch

    def __iter__(self):
        while True:
            yield self.sample()
