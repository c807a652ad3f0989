"""Mixture-of-logistics ray-distribution decoder
(graspnerf_tpu/models/dist_decoder.py:19-89): the fixed-interval bins of
volume queries, the per-sample bins of rendered rays, and the means alone
for the depth loss; use_vis False as in the shipped config."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import geometry


def _head(feats_dim: int, out_dim: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(feats_dim, feats_dim), nn.ELU(),
                         nn.Linear(feats_dim, feats_dim), nn.ELU(),
                         nn.Linear(feats_dim, out_dim))


class MixtureLogisticsDistDecoder(nn.Module):
    """feats [...,32] -> (mean [...,2], var [...,2], aw [...,1])."""

    def __init__(self, feats_dim: int = 32, bias_val: float = 0.05):
        super().__init__()
        self.bias_val = bias_val
        self.mean_decoder = _head(feats_dim, 2)
        self.var_decoder = _head(feats_dim, 2)
        self.aw_decoder = _head(feats_dim, 1)

    def forward(self, feats):
        mean = F.softplus(self.mean_decoder(feats))
        var = F.softplus(self.var_decoder(feats)) + self.bias_val
        aw = torch.sigmoid(self.aw_decoder(feats))
        return mean, var, aw

    def predict_mean(self, feats):
        """The mixture means alone, [...,2] (dist_decoder.py:55-58): the
        depth loss's prediction."""
        return F.softplus(self.mean_decoder(feats))


def compute_prob(depth, mean, var, aw, depth_range, interval=None,
                 fixed_interval_val: float = 0.01, eps: float = 1e-5):
    """Mixture CDF difference over each sample's inverse-depth bin.
    depth [V,qn,rn,dn] projected depths; mean/var [...,2], aw [...,1];
    depth_range [V,2]; interval [1,qn,rn,dn] the rays' sample intervals
    (`geometry.near_far_bounds_ref`), or None for the fixed-width bins of
    volume queries. Returns (alpha_value, visibility, hit_prob), each
    [V,qn,rn,dn]."""
    if interval is None:
        near, far = geometry.near_far_bounds_fixed(depth, depth_range,
                                                   fixed_interval_val)
    else:
        near, far = geometry.near_far_bounds_ref(depth, interval, depth_range)
    mix = torch.cat([aw, 1.0 - aw], -1)
    cdf0 = 0.5 + 0.5 * torch.tanh((near[..., None] - mean) * var)
    cdf1 = 0.5 + 0.5 * torch.tanh((far[..., None] - mean) * var)
    visibility = torch.sum((1.0 - cdf0) * mix, -1)
    hit_prob = torch.sum((cdf1 - cdf0) * mix, -1)
    alpha_value = torch.log(hit_prob / (visibility - hit_prob + eps) + eps)
    return alpha_value, visibility, hit_prob
