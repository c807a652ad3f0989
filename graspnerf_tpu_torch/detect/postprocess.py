"""Grasp volume post-processing on the device
(graspnerf_tpu/detect/postprocess.py:20-93)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.image import (gaussian_filter_3d, binary_dilation_masked,
                         maximum_filter_3d)
from ..sim.transform import Rotation, Transform


def process(tsdf_vol, qual_vol, width_vol, gaussian_filter_sigma: float = 1.0,
            min_width: float = 1.33, max_width: float = 9.33,
            tsdf_thres_high: float = 0.0, tsdf_thres_low: float = -0.85):
    """Smooth quality; zero it far from the predicted surface and where the
    width is out of range. All [res,res,res]."""
    qual = gaussian_filter_3d(qual_vol, gaussian_filter_sigma)
    outside = tsdf_vol > tsdf_thres_high
    inside = (tsdf_thres_low < tsdf_vol) & (tsdf_vol < tsdf_thres_high)
    valid = binary_dilation_masked(outside, ~inside, iterations=2)
    zero = torch.zeros_like(qual)
    qual = torch.where(valid, qual, zero)
    return torch.where((width_vol < min_width) | (width_vol > max_width),
                       zero, qual)


def nms(qual_vol, threshold: float = 0.90, max_filter_size: int = 4):
    """Threshold + cubic max-filter NMS -> the sparse quality volume."""
    zero = torch.zeros_like(qual_vol)
    qual = torch.where(qual_vol < threshold, zero, qual_vol)
    return torch.where(qual == maximum_filter_3d(qual, max_filter_size),
                       qual, zero)


class GraspCandidates(NamedTuple):
    """Top-K candidates with static shapes; empty slots have score 0."""
    indices: torch.Tensor    # [K,3] int64 voxel coords
    scores: torch.Tensor     # [K]
    rotations: torch.Tensor  # [K,4] xyzw
    widths: torch.Tensor     # [K]


def extract_candidates(qual_sparse, rot_vol, width_vol,
                       k: int = 64) -> GraspCandidates:
    """Static top-K over the NMS volume. Ties may come in another order than
    `lax.top_k`'s; callers compare the set of (index, score) with score > 0."""
    res = qual_sparse.shape[0]
    scores, idx = torch.topk(qual_sparse.reshape(-1), k)
    indices = torch.stack([idx // (res * res), (idx // res) % res, idx % res], -1)
    return GraspCandidates(indices, scores, rot_vol.reshape(-1, 4)[idx],
                           width_vol.reshape(-1)[idx])


def candidates_to_grasps(cand: GraspCandidates, voxel_size: float = 0.3 / 40,
                         rng: np.random.RandomState | None = None):
    """Host side: drop empty slots, optionally shuffle, voxel -> metric.
    Returns (grasps [(Transform, width)], scores)."""
    scores = cand.scores.cpu().numpy()
    keep = scores > 0
    idx = cand.indices.cpu().numpy()[keep]
    rots = cand.rotations.cpu().numpy()[keep]
    widths = cand.widths.cpu().numpy()[keep]
    scores = scores[keep]
    order = np.arange(len(scores))
    if rng is not None and len(order):
        order = rng.permutation(len(order))
    grasps = [(Transform(Rotation.from_quat(rots[i]),
                         idx[i].astype(np.float64) * voxel_size),
               float(widths[i] * voxel_size)) for i in order]
    return grasps, scores[order]
