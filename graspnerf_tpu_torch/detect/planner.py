"""Grasp planner API (graspnerf_tpu/detect/planner.py:42-145).

Two stages per planning call, as in the JAX planner: encode the six views,
then query the SDF volume, run the grasp head and post-process on the device.
Only the final candidate list goes to the host. `load_rendered_views` reads
the reference renderer's file contract.
"""
from __future__ import annotations

import os
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .. import tracing
from ..data.database import BLENDER2OPENCV
from ..data.png import read_rgb
from ..models import load_graspnerf, resolve_device
from .postprocess import (process, nms, extract_candidates,
                          candidates_to_grasps)

DEFAULT_BBOX_MIN = np.array([-0.15, -0.15, -0.0503], np.float32)
VOXEL_SIZE = 0.3 / 40
# the planning call's spans (tracing.py); encode and volume are the renderer's
PLAN, UPLOAD, HEAD, HEAD_CNN, HEAD_POST, WAIT, GRASPS = map(tracing.span, (
    "plan", "upload", "head", "head.cnn", "head.post", "wait", "grasps"))


class GraspNeRFPlanner:
    """Inference-only planner.

    params, device, renderer_cfg and use_kernels build the model as
    `models.load_graspnerf` does: on the card when device is None (raising
    without one), in float32 (TF32 off), `use_kernels` False for the
    kernels' plain versions.
    """

    def __init__(self, params: Mapping[str, torch.Tensor], device=None,
                 renderer_cfg: Optional[dict] = None,
                 tsdf_thres_high: float = 0.0, tsdf_thres_low: float = -0.85,
                 qual_threshold: float = 0.90, max_candidates: int = 64,
                 seed: int = 0, use_kernels: bool = True):
        self.device = resolve_device(device)
        self.model = load_graspnerf(params, self.device, renderer_cfg,
                                    use_kernels)
        self.tsdf_thres = (tsdf_thres_high, tsdf_thres_low)
        self.qual_threshold = qual_threshold
        self.max_candidates = max_candidates
        self.seed = seed

    def scene(self, images, extrinsics, Ks, depth_range,
              bbox_min=DEFAULT_BBOX_MIN):
        """The renderer's `ref` dict of float32 tensors on the device."""
        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        with UPLOAD:
            return {"imgs": t(images), "poses": t(extrinsics), "Ks": t(Ks),
                    "depth_range": t(depth_range), "bbox3d_min": t(bbox_min)}

    @torch.no_grad()
    def encode(self, imgs: torch.Tensor):
        """Stage 1, once per scene: (img_feats, ray_feats)."""
        return self.model.nr_net.encode_views(imgs)

    @torch.no_grad()
    def volume(self, ref, img_feats, ray_feats):
        """Stage 2: (tsdf [res]^3, (qual, rot, width), GraspCandidates)."""
        vol = self.model.nr_net.sample_volume(ref, img_feats, ray_feats)
        heads, cand = self.detect(vol)
        return vol, heads, cand

    @torch.no_grad()
    def detect(self, vol):
        """Grasp head and post-processing of a TSDF volume [res]^3 ->
        ((qual, rot, width) [1,res,res,res,C], GraspCandidates)."""
        with HEAD:
            with HEAD_CNN:
                qual, rot, width = self.model.vgn_net(vol[None, ..., None])
            with HEAD_POST:
                high, low = self.tsdf_thres
                q = process(vol, qual[0, ..., 0], width[0, ..., 0],
                            tsdf_thres_high=high, tsdf_thres_low=low)
                cand = extract_candidates(nms(q, self.qual_threshold),
                                          rot[0], width[0, ..., 0],
                                          k=self.max_candidates)
        return (qual, rot, width), cand

    def core(self, images, extrinsics, Ks, depth_range,
             bbox_min=DEFAULT_BBOX_MIN):
        """images [V,h,w,3] in [0,1]; extrinsics [V,3,4] world->cam; Ks
        [V,3,3]; depth_range [V,2]. Returns (tsdf volume [res]^3,
        GraspCandidates, seconds)."""
        V, h, w, _ = images.shape
        if h % 32 or w % 32:
            raise ValueError(f"image size {h}x{w} is not a multiple of 32")
        ref = self.scene(images, extrinsics, Ks, depth_range, bbox_min)
        t0 = time.perf_counter()
        img_feats, ray_feats = self.encode(ref["imgs"])
        vol, _, cand = self.volume(ref, img_feats, ray_feats)
        with WAIT:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return vol, cand, time.perf_counter() - t0

    def __call__(self, images, extrinsics, Ks, depth_range=None,
                 round_idx: int = 0, n_grasp: int = 0):
        """Full planning call: (grasps [(Transform, width)], scores,
        planning seconds), shuffled with the reference's seed."""
        with PLAN:
            if depth_range is None:
                depth_range = np.tile(np.array([[0.2, 0.8]], np.float32),
                                      (images.shape[0], 1))
            vol, cand, toc = self.core(images, extrinsics, Ks, depth_range)
            with GRASPS:
                rng = np.random.RandomState(self.seed + round_idx + n_grasp)
                grasps, scores = candidates_to_grasps(cand, VOXEL_SIZE, rng)
        return grasps, scores, toc


def load_rendered_views(render_dir: str, camera_pose_file: str,
                        view_ids: Sequence[int], wh=(512, 288),
                        K: Optional[np.ndarray] = None):
    """Read the reference renderer's file contract (ref main.py:167-199):
    rgb/%04d.png resized to `wh` (PIL, bilinear), camera_pose.npy (cam->world,
    Blender axes) -> world->cam OpenCV poses, and the fixed vgn_syn
    intrinsics scaled to `wh` unless K is given. Returns (images [V,h,w,3]
    in [0,1], extrinsics [V,3,4], Ks [V,3,3]), numpy float32. Without PIL
    the PNGs must be 8-bit and already at `wh` (`data.png.read_rgb`)."""
    cam_poses = np.load(camera_pose_file)
    imgs = read_rgb([os.path.join(render_dir, "rgb", "%04d.png" % i)
                     for i in view_ids], wh)
    poses = [np.linalg.inv(cam_poses[i] @ BLENDER2OPENCV)[:3, :]
             for i in view_ids]
    if K is None:
        K = np.array([[892.62, 0, 639.5], [0, 892.62, 359.5], [0, 0, 1]],
                     np.float32)
        K[:2] *= wh[0] / 1280.0
    Ks = np.tile(K[None], (len(view_ids), 1, 1)).astype(np.float32)
    return imgs, np.stack(poses).astype(np.float32), Ks
