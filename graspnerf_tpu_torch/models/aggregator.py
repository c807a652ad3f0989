"""NeuS aggregation head (graspnerf_tpu/models/aggregator.py:18-113): the
prob embedding, direction features and IBRNet-NeuS, on the SDF-only branch
(`que_dists=None`) that volume queries take."""
from __future__ import annotations

import torch
import torch.nn as nn

from .ibrnet import IBRNetNeus


def dir_diff_feature(prj_dir, que_dir):
    """[V,qn,rn,dn,3] x [qn,rn,dn,3] -> [V, qn*rn*dn, 4] (direction
    difference | dot)."""
    V = prj_dir.shape[0]
    diff = prj_dir - que_dir[None]
    dot = torch.sum(prj_dir * que_dir[None], -1, keepdim=True)
    return torch.cat([diff, dot], -1).reshape(V, -1, 4)


def to_vnc(x):
    """[V,qn,rn,dn,C] -> [V, qn*rn*dn, C]."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


class SingleVariance(nn.Module):
    """Learned NeuS sharpness inv_s = exp(10 * variance)."""

    def __init__(self, init_val: float = 0.3):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(init_val))

    def forward(self):
        return torch.clamp(torch.exp(self.variance * 10.0), 1e-6, 1e6), self.variance


class NeusAggregationNet(nn.Module):
    """prob-embed + IBRNetNeus; `sdf` returns the volume path's SDF."""

    def __init__(self, neuray_dim: int = 32, init_s: float = 0.3,
                 use_kernels: bool = True):
        super().__init__()
        self.prob_embed = nn.Sequential(nn.Linear(32 + 2, neuray_dim), nn.ReLU(),
                                        nn.Linear(neuray_dim, neuray_dim))
        self.agg_impl = IBRNetNeus(neuray_dim, use_kernels=use_kernels)
        self.deviation_network = SingleVariance(init_s)

    def sdf(self, prj, que_dir, que_pts):
        """prj: the projection dict ([V,qn,rn,dn,C] tensors) with `vis` and
        `hit_prob`; que_dir/que_pts [qn,rn,dn,3] -> sdf [qn,rn,dn]."""
        qn, rn, dn, _ = que_pts.shape
        pe = torch.cat([prj["ray_feats"], (prj["hit_prob"] - 0.5) * 2,
                        (prj["vis"] - 0.5) * 2], -1)
        agg = self.agg_impl
        feat_const, num_valid, _, _ = agg.view_fuse(
            to_vnc(prj["rgb_feats"]), to_vnc(self.prob_embed(pe)),
            dir_diff_feature(prj["dir"], que_dir), to_vnc(prj["mask"]))
        sdf = agg.geometry(feat_const.reshape(qn * rn, dn, -1), que_pts,
                           num_valid.reshape(qn * rn, dn, 1))
        return sdf.reshape(qn, rn, dn)
