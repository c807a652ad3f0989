"""Synthetic scene generator (graspnerf_tpu/data/synthetic.py): an analytic
stand-in for the vgn_syn dataset.

The reference trains on Blender-rendered tabletop scenes (rgb/depth/mask per
view + GT TSDF + GIGA grasp labels -- ref dataset/database.py:211-294,
data_generator/). This module produces batches with the same structure from
procedurally generated primitive scenes (spheres/boxes on a table, analytic
ray-traced depth, Lambert-shaded RGB, fused GT TSDF, surface-derived grasp
labels), from the same `RandomState` draws in the same order as the JAX
package's: numpy, the native tracer (data/native.py) and the port's TSDF
fusion (ops/tsdf.py) on the CPU.

Camera model mirrors the reference capture rig: poses on a radius-0.5
hemisphere looking at the workspace centre (ref rd/render_utils.py:420-481),
pinhole intrinsics, fixed depth range [0.2, 0.8] (ref database.py:118).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..ops.tsdf import integrate_tsdf, grid_points, RESOLUTION, VOLUME_SIZE

BBOX_MIN = np.array([-0.15, -0.15, -0.05], np.float32)
WORKSPACE_CENTER = BBOX_MIN + VOLUME_SIZE / 2  # (0, 0, 0.1)
DEPTH_RANGE = np.array([0.2, 0.8], np.float32)


def hemisphere_poses(n_az: int = 6, n_el: int = 4, radius: float = 0.5,
                     center=WORKSPACE_CENTER):
    """n_az × n_el world→cam poses looking at `center` (z-up)."""
    poses = []
    for ei in range(n_el):
        el = np.deg2rad(15 + 30 * ei / max(n_el - 1, 1))
        for ai in range(n_az):
            az = 2 * np.pi * ai / n_az
            eye = np.asarray(center) + radius * np.array(
                [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)])
            fwd = np.asarray(center) - eye
            fwd /= np.linalg.norm(fwd)
            up = np.array([0.0, 0.0, 1.0])
            right = np.cross(fwd, up)
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)
            R = np.stack([right, down, fwd], 0)
            t = -R @ eye
            poses.append(np.concatenate([R, t[:, None]], 1))
    return np.stack(poses).astype(np.float32)


def intrinsics(h: int, w: int, f_scale: float = 0.9):
    f = f_scale * w
    return np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]],
                    np.float32)


class Scene:
    """Primitives: spheres [(c,r)], axis-aligned boxes [(lo,hi)] + table z=0."""

    def __init__(self, rng: np.random.RandomState, n_objects: int = 4):
        self.spheres, self.boxes = [], []
        for _ in range(n_objects):
            kind = rng.rand() < 0.5
            cx, cy = rng.uniform(-0.09, 0.09, 2)
            if kind:
                r = rng.uniform(0.015, 0.035)
                self.spheres.append((np.array([cx, cy, r], np.float32),
                                     np.float32(r)))
            else:
                sx, sy, sz = rng.uniform(0.015, 0.04, 3)
                lo = np.array([cx - sx, cy - sy, 0.0], np.float32)
                hi = np.array([cx + sx, cy + sy, 2 * sz], np.float32)
                self.boxes.append((lo, hi))
        self.colors = rng.uniform(0.2, 0.9, (len(self.spheres)
                                             + len(self.boxes) + 1, 3))

    # -------------------------------------------------------- ray tracing
    def trace(self, origins, dirs):
        """origins/dirs [N,3] (dirs unit). Returns (t [N], normal [N,3],
        obj_id [N] with -1 = miss, table = last id).

        Uses the native C++/OpenMP tracer (data/native.py) when it builds;
        the numpy path is the correctness oracle and fallback."""
        from . import native
        if native.available():
            spheres = (np.stack([np.r_[c, r] for c, r in self.spheres])
                       if self.spheres else np.zeros((0, 4), np.float32))
            boxes = (np.stack([np.r_[lo, hi] for lo, hi in self.boxes])
                     if self.boxes else np.zeros((0, 6), np.float32))
            return native.trace_rays(spheres, boxes, origins, dirs)
        return self._trace_numpy(origins, dirs)

    def _trace_numpy(self, origins, dirs):
        N = origins.shape[0]
        t_best = np.full(N, np.inf, np.float32)
        n_best = np.zeros((N, 3), np.float32)
        id_best = np.full(N, -1, np.int32)
        oid = 0
        for c, r in self.spheres:
            oc = origins - c
            b = np.sum(dirs * oc, -1)
            disc = b * b - (np.sum(oc * oc, -1) - r * r)
            ok = disc > 0
            t = np.where(ok, -b - np.sqrt(np.maximum(disc, 0)), np.inf)
            hit = ok & (t > 1e-4) & (t < t_best)
            t_best = np.where(hit, t, t_best)
            p = origins + dirs * t[:, None]
            n = (p - c) / r
            n_best = np.where(hit[:, None], n, n_best)
            id_best = np.where(hit, oid, id_best)
            oid += 1
        for lo, hi in self.boxes:
            inv = 1.0 / np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
            t0 = (lo - origins) * inv
            t1 = (hi - origins) * inv
            tmin = np.minimum(t0, t1)
            tmax = np.maximum(t0, t1)
            tn = tmin.max(-1)
            tf = tmax.min(-1)
            ok = (tn < tf) & (tf > 0)
            t = np.where(ok, tn, np.inf)
            hit = ok & (t > 1e-4) & (t < t_best)
            axis = np.argmax(tmin, -1)
            sign = -np.sign(np.take_along_axis(dirs, axis[:, None], 1))[:, 0]
            n = np.zeros((N, 3), np.float32)
            n[np.arange(N), axis] = sign
            t_best = np.where(hit, t, t_best)
            n_best = np.where(hit[:, None], n, n_best)
            id_best = np.where(hit, oid, id_best)
            oid += 1
        # table plane z = 0
        dz = dirs[:, 2]
        t = np.where(np.abs(dz) > 1e-9, -origins[:, 2] / dz, np.inf)
        hit = (t > 1e-4) & (t < t_best)
        t_best = np.where(hit, t, t_best)
        n_best = np.where(hit[:, None], np.array([0.0, 0.0, 1.0]), n_best)
        id_best = np.where(hit, oid, id_best)
        return t_best, n_best, id_best

    def render(self, pose, K, h, w):
        """Returns rgb [h,w,3] float in [0,1], depth [h,w] (z in cam frame,
        0 = miss), fg_mask [h,w] (non-table hits)."""
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
        Kinv = np.linalg.inv(K)
        cam_dirs = pix @ Kinv.T
        R, t = pose[:3, :3], pose[:3, 3]
        eye = -R.T @ t
        world_dirs = cam_dirs @ R  # R^T @ d per-row
        norm = np.linalg.norm(world_dirs, axis=-1)
        unit = world_dirs / norm[:, None]
        origins = np.broadcast_to(eye, unit.shape)
        tt, n, oid = self.trace(origins.astype(np.float32),
                                unit.astype(np.float32))
        hit = np.isfinite(tt)
        light = np.array([0.3, -0.5, 0.8])
        light = light / np.linalg.norm(light)
        lam = np.clip(n @ light, 0.0, 1.0) * 0.7 + 0.3
        base = self.colors[np.clip(oid, 0, len(self.colors) - 1)]
        rgb = np.where(hit[:, None], base * lam[:, None], 0.05)
        zdepth = np.where(hit, tt * (unit @ R[2]), 0.0)
        fg = hit & (oid >= 0) & (oid < len(self.spheres) + len(self.boxes))
        return (rgb.reshape(h, w, 3).astype(np.float32),
                zdepth.reshape(h, w).astype(np.float32),
                fg.reshape(h, w))


class SyntheticSceneDataset:
    """Generates single-scene trainer batches (train/trainer.py's contract)."""

    def __init__(self, n_views: int = 6, h: int = 96, w: int = 128,
                 n_grasps: int = 32, n_rays: int = 512, n_objects: int = 4,
                 resolution: int = RESOLUTION, seed: int = 0,
                 fuse_views: int = 12):
        self.n_views, self.h, self.w = n_views, h, w
        self.n_grasps, self.n_rays = n_grasps, n_rays
        self.n_objects = n_objects
        self.res = resolution
        self.fuse_views = fuse_views
        self.rng = np.random.RandomState(seed)
        self.all_poses = hemisphere_poses()
        self.K = intrinsics(h, w)

    def _grasp_labels(self, tsdf, rng):
        """Sample voxels near the observed surface; positives = graspable band
        slightly above the table, with gripper-symmetric rotation pairs."""
        res = self.res
        pts = grid_points(res).numpy().reshape(res, res, res, 3)
        near_surface = (np.abs(tsdf) < 0.3) & (tsdf != -1.0)
        iz = pts[..., 2]
        cand = np.argwhere(near_surface)
        if len(cand) == 0:
            cand = np.stack(np.unravel_index(
                rng.randint(0, res ** 3, 64), (res, res, res)), -1)
        sel = cand[rng.randint(0, len(cand), self.n_grasps)]
        z = iz[sel[:, 0], sel[:, 1], sel[:, 2]]
        label = ((z > 0.06) & (z < 0.25)).astype(np.float32)
        # random unit quats + z-rotated-by-pi symmetric partner (xyzw)
        q = rng.randn(self.n_grasps, 4)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        qz = np.array([0.0, 0.0, 1.0, 0.0])  # rot_z(pi) in xyzw

        def mul(a, b):
            x1, y1, z1, w1 = a.T
            x2, y2, z2, w2 = b
            return np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                             w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                             w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                             w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)
        q2 = mul(q, qz)
        rot = np.stack([q, q2], 1).astype(np.float32)
        width = rng.uniform(1.33, 9.33, self.n_grasps).astype(np.float32)
        return sel.astype(np.int32), label, rot, width

    def sample(self) -> Dict:
        rng = self.rng
        scene = Scene(rng, self.n_objects)
        # pick n_views equally spaced azimuths at a random elevation row,
        # plus a random query view (ref train_dataset.py:204-209)
        row = rng.randint(0, 4) * 6
        ref_ids = [row + (i * 6) // self.n_views for i in range(self.n_views)]
        que_id = rng.randint(0, len(self.all_poses))

        rgbs, depths, fgs = [], [], []
        for i in ref_ids + [que_id]:
            rgb, depth, fg = scene.render(self.all_poses[i], self.K,
                                          self.h, self.w)
            rgbs.append(rgb)
            depths.append(depth)
            fgs.append(fg)
        rgbs = np.stack(rgbs)
        depths = np.stack(depths)

        # GT TSDF fused from extra hemisphere depth views (stand-in for the
        # dataset's precomputed GT volume); unobserved voxels → -1 like the
        # reference's sdf_gt convention (database.py:207-209)
        fuse_ids = rng.choice(len(self.all_poses), self.fuse_views,
                              replace=False)
        fuse_depths, fuse_exts, fuse_Ks = [], [], []
        for i in fuse_ids:
            _, d, _ = scene.render(self.all_poses[i], self.K, self.h, self.w)
            fuse_depths.append(d)
            ext = np.eye(4, dtype=np.float32)
            ext[:3, :] = self.all_poses[i]
            # TSDF integrator works in volume-local coords
            shift = np.eye(4, dtype=np.float32)
            shift[:3, 3] = BBOX_MIN
            fuse_exts.append(ext @ shift)
            fuse_Ks.append(self.K)
        tsdf, wgt = integrate_tsdf(np.stack(fuse_depths), np.stack(fuse_Ks),
                                   np.stack(fuse_exts), VOLUME_SIZE, self.res,
                                   device="cpu")
        tsdf = np.where(wgt.numpy() > 0, tsdf.numpy(), -1.0).astype(np.float32)

        grasp_index, label, rot, width = self._grasp_labels(tsdf, rng)

        # foreground-biased ray sampling (ref train_dataset.py:303-318)
        fg = fgs[-1].reshape(-1)
        n_fg = min(self.n_rays // 2, int(fg.sum()))
        fg_idx = np.flatnonzero(fg)
        idx = np.concatenate([
            fg_idx[rng.randint(0, max(len(fg_idx), 1), n_fg)] if n_fg else
            np.empty(0, np.int64),
            rng.randint(0, self.h * self.w, self.n_rays - n_fg)])
        coords = np.stack([idx % self.w, idx // self.w],
                          -1).astype(np.float32)[None]

        V = self.n_views
        dr = DEPTH_RANGE[None]
        data = {
            "ref": {"imgs": rgbs[:V], "poses": self.all_poses[ref_ids],
                    "Ks": np.tile(self.K[None], (V, 1, 1)),
                    "depth_range": np.tile(dr, (V, 1)),
                    "bbox3d_min": BBOX_MIN},
            "que": {"imgs": rgbs[V:], "coords": coords,
                    "poses": self.all_poses[que_id][None],
                    "Ks": self.K[None], "depth_range": dr},
            "grasp_index": grasp_index,
        }
        return {
            "data": data,
            "true_depth": depths[:V][..., None],
            "sdf_gt": tsdf,
            "grasp_label": label,
            "grasp_rot": rot,
            "grasp_width": width,
        }

    def __iter__(self):
        while True:
            yield self.sample()
