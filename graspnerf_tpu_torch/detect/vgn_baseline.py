"""Classical-TSDF VGN baseline planner (graspnerf_tpu/detect/vgn_baseline.py;
ref: src/gd/detection.py:13-57).

The non-NeRF path: fuse depth images into a TSDF (ops/tsdf.py, in place of
the reference's Open3D volume) and run only the 3D-CNN grasp head, both on
the device. It uses the classical thresholds (tsdf_thres_high=0.5,
low=1e-3), since the fused volume is a [-1, 1] classical TSDF, not a NeuS
SDF.
"""
from __future__ import annotations

import time
from typing import Mapping

import numpy as np
import torch

from ..models import VGNConvNet, resolve_device
from ..models.renderer import float32_on
from ..ops.tsdf import integrate_tsdf, VOLUME_SIZE, RESOLUTION
from .postprocess import process, nms, extract_candidates, candidates_to_grasps

VOXEL_SIZE = VOLUME_SIZE / RESOLUTION
TSDF_THRES_HIGH, TSDF_THRES_LOW = 0.5, 1e-3


class VGNPlanner:
    """Depth in, grasps out. params: a VGNConvNet state dict (the keys of
    `GraspNeRF`'s `vgn_net.*` without that prefix), loaded strictly on
    `device`: the card when None, raising without one."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 qual_threshold: float = 0.90, max_candidates: int = 64,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        float32_on(self.device)
        model = VGNConvNet()
        model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval()
        self.qual_threshold = qual_threshold
        self.max_candidates = max_candidates
        self.seed = seed

    def fuse(self, depth_imgs, Ks, extrinsics) -> torch.Tensor:
        """depth_imgs [n,h,w] metric; extrinsics [n,4,4] volume-local->cam
        -> the 40^3 TSDF on the device (0 where unobserved)."""
        return integrate_tsdf(depth_imgs, Ks, extrinsics,
                              device=self.device)[0]

    @torch.no_grad()
    def detect(self, tsdf: torch.Tensor):
        """Grasp head and post-processing of a TSDF [res]^3 ->
        ((qual, rot, width) [1,res,res,res,C], GraspCandidates)."""
        qual, rot, width = self.model(tsdf[None, ..., None])
        q = process(tsdf, qual[0, ..., 0], width[0, ..., 0],
                    tsdf_thres_high=TSDF_THRES_HIGH,
                    tsdf_thres_low=TSDF_THRES_LOW)
        cand = extract_candidates(nms(q, self.qual_threshold), rot[0],
                                  width[0, ..., 0], k=self.max_candidates)
        return (qual, rot, width), cand

    def core(self, depth_imgs, Ks, extrinsics):
        """-> (tsdf [res]^3, GraspCandidates, seconds)."""
        t0 = time.time()
        tsdf = self.fuse(depth_imgs, Ks, extrinsics)
        _, cand = self.detect(tsdf)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return tsdf, cand, time.time() - t0

    def __call__(self, depth_imgs, Ks, extrinsics, round_idx: int = 0,
                 n_grasp: int = 0):
        """-> (grasps [(Transform, width)], scores, planning seconds),
        shuffled with the reference's seed."""
        _, cand, toc = self.core(depth_imgs, Ks, extrinsics)
        rng = np.random.RandomState(self.seed + round_idx + n_grasp)
        grasps, scores = candidates_to_grasps(cand, VOXEL_SIZE, rng)
        return grasps, scores, toc
