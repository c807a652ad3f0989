"""The grasp post-processing of a planning call: quality smoothed and
masked by the TSDF and the width, thresholded, non-maximum suppression,
the best `max_candidates` (scipy.ndimage semantics, as the source's
detection)."""
from __future__ import annotations

import torch

from . import ops


def process_quality(tsdf, qual, width, high: float = 0.0,
                    low: float = -0.85, min_width: float = 1.33,
                    max_width: float = 9.33):
    """qual, width [res]^3 -> the smoothed quality, zero far from the
    predicted surface and where the width is out of range."""
    q = ops.gaussian_filter_3d(qual, 1.0)
    outside = tsdf > high
    inside = (low < tsdf) & (tsdf < high)
    valid = ops.binary_dilation_masked(outside, ~inside, 2)
    q = torch.where(valid, q, torch.zeros_like(q))
    return torch.where((width < min_width) | (width > max_width),
                       torch.zeros_like(q), q)


def candidates(q, rot, width, threshold: float, k: int = 64):
    """The NMS peaks of the processed quality q [res]^3 at or above
    threshold, best first, at most k: [(voxel (i, j, l), score, rotation
    xyzw, width in voxels)] as host values."""
    qt = torch.where(q < threshold, torch.zeros_like(q), q)
    peaks = torch.where(qt == ops.maximum_filter_3d(qt, 4), qt,
                        torch.zeros_like(qt))
    scores, idx = torch.topk(peaks.reshape(-1), k)
    res = q.shape[0]
    out = []
    for s, i in zip(scores.tolist(), idx.tolist()):
        if s <= 0:
            break
        v = (i // (res * res), (i // res) % res, i % res)
        out.append((v, s, rot[v].tolist(), float(width[v])))
    return out


def peak_scores(q):
    """Every NMS peak's score of q (threshold 0), best first."""
    peaks = torch.where(q == ops.maximum_filter_3d(q, 4), q,
                        torch.zeros_like(q))
    return torch.sort(peaks[peaks > 0], descending=True).values.tolist()
