"""NeuS aggregation head (graspnerf_tpu/models/aggregator.py:18-123): the
prob embedding, direction features and IBRNet-NeuS, then the NeuS alpha.
`forward` is the render path's (sdf, colours, ∇sdf, alpha); `sdf` is the
SDF-only branch that volume queries take (`que_dists=None` in JAX).
The prob embedding computes in `dtype` (aggregator.py:75-110); the alpha
and ∇sdf's norm are float32."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .ibrnet import IBRNetNeus
from .layers import Linear


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


def neus_alpha(sdf, grad, que_dir, que_dists, inv_s, cos_anneal_ratio=1.0):
    """NeuS opacity of each sample from its SDF and ∇sdf
    (aggregator.py:49-63). sdf [qn,rn,dn], grad/que_dir [qn,rn,dn,3],
    que_dists [qn,rn,dn] sample intervals, inv_s the sharpness."""
    true_cos = torch.sum(-que_dir * grad, -1)
    iter_cos = -(F.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + F.relu(-true_cos) * cos_anneal_ratio)
    est_next = sdf + iter_cos * que_dists * 0.5
    est_prev = sdf - iter_cos * que_dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    p = prev_cdf - next_cdf
    return torch.clamp((p + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)


def gradient_error(grad):
    """mean (|∇sdf| - 1)^2 over every point, [1,1] (the eikonal term)."""
    return torch.mean((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2
                      ).reshape(1, 1)


class SingleVariance(nn.Module):
    """Learned NeuS sharpness inv_s = exp(10 * variance)."""

    def __init__(self, init_val: float = 0.3):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(init_val))

    def forward(self):
        return torch.clamp(torch.exp(self.variance * 10.0), 1e-6, 1e6), self.variance


class NeusAggregationNet(nn.Module):
    """prob-embed + IBRNetNeus + NeuS alpha. The projection dict `prj` holds
    [V,qn,rn,dn,C] tensors with `vis` and `hit_prob`; que_dir/que_pts are
    [qn,rn,dn,3]."""

    def __init__(self, neuray_dim: int = 32, init_s: float = 0.3,
                 use_kernels: bool = True, dtype=torch.float32):
        super().__init__()
        self.prob_embed = nn.Sequential(
            Linear(32 + 2, neuray_dim, dtype=dtype), nn.ReLU(),
            Linear(neuray_dim, neuray_dim, dtype=dtype))
        self.agg_impl = IBRNetNeus(neuray_dim, use_kernels=use_kernels,
                                   dtype=dtype)
        self.deviation_network = SingleVariance(init_s)

    def fuse_inputs(self, prj, que_dir):
        """The view fuse's [V,N,C] inputs: rgb_feats, prob embedding,
        direction features, mask."""
        pe = torch.cat([prj["ray_feats"], (prj["hit_prob"] - 0.5) * 2,
                        (prj["vis"] - 0.5) * 2], -1)
        return (to_vnc(prj["rgb_feats"]), to_vnc(self.prob_embed(pe)),
                dir_diff_feature(prj["dir"], que_dir), to_vnc(prj["mask"]))

    def sdf(self, prj, que_dir, que_pts):
        """The volume path: sdf [qn,rn,dn], without ∇sdf or colours."""
        qn, rn, dn, _ = que_pts.shape
        agg = self.agg_impl
        feat_const, num_valid, _, _ = agg.view_fuse(
            *self.fuse_inputs(prj, que_dir))
        sdf = agg.geometry(feat_const.reshape(qn * rn, dn, -1), que_pts,
                           num_valid.reshape(qn * rn, dn, 1))
        return sdf.reshape(qn, rn, dn)

    def forward(self, prj, que_dir, que_pts, que_dists,
                cos_anneal_ratio: float = 1.0):
        """The render path, que_dists [qn,rn,dn] the sample intervals ->
        {sdf [qn,rn,dn], colors [qn,rn,dn,3], grad (∇sdf) [qn,rn,dn,3],
        alpha [qn,rn,dn], grad_error [1,1] (mean (|∇sdf| - 1)^2), s [1,1]
        (the raw variance)}."""
        qn, rn, dn, _ = que_pts.shape
        colors, sdf, grad = self.agg_impl(*self.fuse_inputs(prj, que_dir),
                                          que_pts, (qn * rn, dn))
        sdf = sdf[..., 0].reshape(qn, rn, dn)
        inv_s, s_raw = self.deviation_network()
        return {"sdf": sdf, "colors": colors.reshape(qn, rn, dn, 3),
                "grad": grad,
                "alpha": neus_alpha(sdf, grad, que_dir, que_dists, inv_s,
                                    cos_anneal_ratio),
                "grad_error": gradient_error(grad),
                "s": s_raw.detach().reshape(1, 1)}
