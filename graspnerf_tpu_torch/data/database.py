"""vgn_syn scene database — the reference's on-disk contract
(ref: src/nr/dataset/database.py:211-327, asset.py).

A copy of graspnerf_tpu/data/database.py (importing the JAX package imports
jax), with its quaternion product inlined in numpy. cv2 and PIL stay lazy
imports: the synthetic path never reaches them, and where PIL does not
import, the in-tree PNG decoder (data/png.py) reads the generator's
images.

Scene directory layout (produced by the reference's Blender data generator,
§SURVEY 3.4):
    <root>/<scene_type>/<split>/<scene_id>/
        rgb/%04d.png          24 hemisphere views
        depth/%04d.exr        float depth (optional)
        mask/%04d.exr         instance masks (optional)
        camera_pose.npy       [24,4,4] cam→world, Blender axes
    <sdf_root>/<scene_id>.npz  GT TSDF in [0,1] (mapped to [-1,1] here)
    <grasp_root>/<scene_id>.csv GIGA grasp labels

Images are loaded at scale 0.8 of 640x360 → 512x288 like the reference
(database.py:69-72,107-109), intrinsics K = 892.62/2 * scale.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from .png import read_rgb

BLENDER2OPENCV = np.array([[1, 0, 0, 0], [0, -1, 0, 0],
                           [0, 0, -1, 0], [0, 0, 0, 1]], np.float32)
DEPTH_RANGE = np.array([0.2, 0.8], np.float32)
BBOX3D = np.array([[-0.15, -0.15, -0.05], [0.15, 0.15, 0.25]], np.float32)
TOTAL_VIEWS = 24


def _quat_multiply(q1, q2):
    """Hamilton product, xyzw (graspnerf_tpu/ops/quat.py:23-33)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], -1)


def _read_exr(path: str) -> np.ndarray:
    """Reference contract EXR (depth/mask) → [H,W] float32. Decoded by the
    in-tree numpy reader (data/exr.py — this environment has no EXR-capable
    cv2/imageio); a cv2 build with EXR support is used as fallback if the
    file uses an unsupported compression."""
    try:
        from .exr import read_exr
        img = read_exr(path)
    except Exception:
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        import cv2
        img = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise FileNotFoundError(path)
    return img[..., 0] if img.ndim == 3 else img


class VGNSynDatabase:
    """One scene's views + labels with the reference's conventions."""

    def __init__(self, scene_dir: str, sdf_path: Optional[str] = None,
                 grasp_csv: Optional[str] = None, scale: float = 0.8):
        self.dir = Path(scene_dir)
        self.sdf_path = sdf_path
        self.grasp_csv = grasp_csv
        self.scale = scale
        self.wh = (int(640 * scale), int(360 * scale))  # 512x288
        cam = np.load(self.dir / "camera_pose.npy")
        # cam→world blender → world→cam opencv (ref database.py:110-111)
        self.poses = np.stack(
            [np.linalg.inv(p @ BLENDER2OPENCV)[:3, :] for p in cam]
        ).astype(np.float32)
        K = np.array([[892.62, 0, 639.5], [0, 892.62, 359.5], [0, 0, 1]],
                     np.float32)
        K[:2] *= scale / 2.0  # vgn_syn halves K (ref main.py:106-109)
        self.K = K

    def __len__(self):
        return min(TOTAL_VIEWS, len(self.poses))

    def get_image(self, i: int) -> np.ndarray:
        return self.get_images([i])[0]

    def get_images(self, ids) -> np.ndarray:
        """rgb/%04d.png of each view in `ids` as float32 RGB in [0, 1] at
        `wh`, [len(ids), h, w, 3], as PIL's convert("RGB") and bilinear
        resize give them (`png.read_rgb`: PIL where it imports, else the
        in-tree decoder for 8-bit PNGs already at `wh`)."""
        return read_rgb([str(self.dir / "rgb" / ("%04d.png" % i))
                         for i in ids], self.wh)

    def _read_map(self, sub: str, i: int) -> Optional[np.ndarray]:
        """Reads %04d.exr (reference contract) or %04d.npy (our generator)."""
        exr = self.dir / sub / ("%04d.exr" % i)
        npy = self.dir / sub / ("%04d.npy" % i)
        if exr.exists():
            arr = _read_exr(str(exr))
        elif npy.exists():
            arr = np.load(npy)
        else:
            return None
        if arr.shape[:2] != (self.wh[1], self.wh[0]):
            import cv2
            arr = cv2.resize(arr.astype(np.float32), self.wh,
                             interpolation=cv2.INTER_NEAREST)
        return arr

    def get_depth(self, i: int) -> Optional[np.ndarray]:
        d = self._read_map("depth", i)
        return None if d is None else d.astype(np.float32)

    def get_mask(self, i: int) -> Optional[np.ndarray]:
        m = self._read_map("mask", i)
        return None if m is None else m > 0

    def get_pose(self, i: int) -> np.ndarray:
        return self.poses[i]

    def get_K(self, i: int) -> np.ndarray:
        return self.K.copy()

    def get_depth_range(self, i: int) -> np.ndarray:
        return DEPTH_RANGE.copy()

    def get_sdf(self) -> Optional[np.ndarray]:
        """GT TSDF: stored [0,1] → [-1,1] (ref database.py:207-209).
        Parsed once per database instance (ref asset.py:41-49 caches all
        labels eagerly at import; here lazily on first access)."""
        if hasattr(self, "_sdf_cache"):
            return self._sdf_cache
        if self.sdf_path is None or not os.path.exists(self.sdf_path):
            self._sdf_cache = None
            return None
        grid = np.load(self.sdf_path)["grid"]
        self._sdf_cache = (grid.squeeze().astype(np.float32) * 2.0) - 1.0
        return self._sdf_cache

    def get_grasp_info(self):
        """GIGA grasps.csv → (index [n,3], label, rot [n,2,4] xyzw, width
        in voxels) (ref database.py:278-294). CSV parsed once per instance."""
        if hasattr(self, "_grasp_cache"):
            return self._grasp_cache
        self._grasp_cache = self._parse_grasp_info()
        return self._grasp_cache

    def _parse_grasp_info(self):
        if self.grasp_csv is None or not os.path.exists(self.grasp_csv):
            return None
        import csv as _csv
        voxel = 0.3 / 40
        rows = list(_csv.DictReader(open(self.grasp_csv)))
        idx, labels, rots, widths = [], [], [], []
        for r in rows:
            if "i" in r:  # reference schema: voxel indices + width in voxels
                # (ref database.py:278-294 round(i,j,k), width read verbatim)
                pos = np.array([float(r["i"]), float(r["j"]), float(r["k"])])
                idx.append(np.clip(np.round(pos), 0, 39).astype(np.int32))
                widths.append(float(r["width"]))
            else:  # legacy x,y,z-in-meters schema; floor — positions written
                # as voxel centers (idx+0.5)*voxel sit exactly on round()'s
                # half-voxel boundary, which shifted ~half the labels to idx+1
                pos = np.array([float(r["x"]), float(r["y"]), float(r["z"])])
                idx.append(np.clip(np.floor(pos / voxel), 0,
                                   39).astype(np.int32))
                widths.append(float(r["width"]) / voxel)
            labels.append(float(r["label"]))
            q = np.array([float(r["qx"]), float(r["qy"]), float(r["qz"]),
                          float(r["qw"])])
            qz = np.array([0.0, 0.0, 1.0, 0.0])  # rot_z(pi), gripper symmetry
            rots.append(np.stack([q, _quat_multiply(q, qz)]))
        return (np.stack(idx), np.asarray(labels, np.float32),
                np.stack(rots).astype(np.float32),
                np.asarray(widths, np.float32))


def discover_scenes(root: str, scene_types=("pile", "packed"),
                    split: str = "train") -> List[str]:
    """Scene discovery (ref asset.py:1-49)."""
    out = []
    for t in scene_types:
        base = Path(root) / t / split
        if base.exists():
            out += [str(p) for p in sorted(base.iterdir()) if p.is_dir()]
    return out


# ------------------------------------------------- name-string registry
# The reference addresses scenes by a slash-joined database name
# "vgn_syn/<split>/<scene_type>/<scene_split>/<scene_id>/<bg>_<scale>"
# (ref database.py:57-76 GraspSynDatabase.__init__, :297-305
# parse_database_name). Its registry ships only the vgn_syn family (all
# other types raise NotImplementedError); the same holds here.
name2database = {"vgn_syn": VGNSynDatabase}


def parse_database_name(database_name: str, train_root: str = "",
                        test_root: str = "", sdf_root: str = None,
                        grasp_root: str = None) -> VGNSynDatabase:
    """`vgn_syn/train/pile/train/scene_0001/w_0.8` -> VGNSynDatabase.

    train_root/test_root point at the dataset roots (the reference hardcodes
    VGN_TRAIN_ROOT / VGN_TEST_ROOT in asset.py); the final component carries
    the image scale (`w_0.8` -> 0.8)."""
    parts = database_name.split("/")
    if len(parts) != 6:
        raise ValueError(f"bad database name {database_name!r}")
    tp, split, scene_type, scene_split, scene_id, bg_size = parts
    if tp not in name2database:
        raise NotImplementedError(tp)
    scale = float(bg_size.split("_")[1])
    root = train_root if split == "train" else test_root
    scene_dir = os.path.join(root, scene_type, scene_split, scene_id)
    sdf = os.path.join(sdf_root, f"{scene_id}.npz") if sdf_root else None
    csv = os.path.join(grasp_root, f"{scene_id}.csv") if grasp_root else None
    return name2database[tp](scene_dir, sdf, csv, scale=scale)


def get_database_split(database: VGNSynDatabase, split_type: str = "val"):
    """Per-scene view split (ref database.py:307-327): val views are
    img_ids[2:24:8] (test additionally holds out view 0); train views are
    the rest."""
    ids = list(range(len(database)))
    val_ids = ids[2:24:8]
    if split_type.startswith("test"):
        val_ids = val_ids + [0]
    train_ids = [i for i in ids if i not in val_ids]
    return train_ids, val_ids
