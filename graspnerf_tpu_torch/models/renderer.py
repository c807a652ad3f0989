"""Generalizable NeRF renderer and grasp network, volume path
(graspnerf_tpu/models/renderer.py:42-75,133-140,219-241,293-323).

    6 ref images --ResUNet--> img_feats --+
                 --ResUNet--> ray_feats --+--VisEncoder--> ray_feats
    40^3 grid --project--> epipolar gather --dist decoder--> hit/vis
              --prob embed + view fuse + geometry head--> SDF volume
              --3D CNN--> grasp quality / rotation / width

Data contract (float32, channels-last): ref = {imgs [V,H,W,3], poses
[V,3,4] world->cam, Ks [V,3,3], depth_range [V,2], bbox3d_min [3]}.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..ops import geometry
from ..ops.epipolar_gather import epipolar_gather, epipolar_gather_plain
from ..ops.tsdf import grid_points
from .aggregator import NeusAggregationNet
from .dist_decoder import MixtureLogisticsDistDecoder, compute_prob
from .grasp_head import VGNConvNet
from .nn_blocks import ResUNetLight, RayFeatInitNet, VisEncoder


def project_to_views(ref: Dict[str, torch.Tensor], que_pts: torch.Tensor,
                     img_feats: torch.Tensor, ray_feats: torch.Tensor,
                     use_kernels: bool = True):
    """Project query points [qn,rn,dn,3] into every view and gather.
    Returns [V,qn,rn,dn,C] tensors: dir(3), pts(2), depth(1), mask(1),
    ray_feats(32), rgb_feats(35) = rgb | img_feats (the JAX dict's `rgb` and
    `img_feats`, already concatenated as the aggregator uses them)."""
    qn, rn, dn, _ = que_pts.shape
    pts = que_pts.reshape(-1, 3)
    V, h, w, _ = ref["imgs"].shape
    xy, depth, valid = geometry.project_points(pts, ref["poses"], ref["Ks"], h, w)
    xy = xy.contiguous()   # einsum may hand back a permuted layout
    gather = epipolar_gather if use_kernels else epipolar_gather_plain
    rgb_feats, prj_ray_feats = gather(ref["imgs"], img_feats, ray_feats, xy,
                                      valid)

    def r(x):
        return x.reshape(V, qn, rn, dn, -1)

    return {"dir": r(geometry.view_directions(pts, ref["poses"])), "pts": r(xy),
            "depth": r(depth), "mask": r(valid.to(torch.float32)),
            "ray_feats": r(prj_ray_feats), "rgb_feats": r(rgb_feats)}


def volume_query_points(res: int, size: float,
                        bbox_min: torch.Tensor) -> torch.Tensor:
    """The res^3 workspace grid as [1, res^2, res, 3]: res^2 "rays" (the
    z-columns) of res samples each, sampled top-down (z flipped)."""
    pts = grid_points(res, size, bbox_min.device) + bbox_min
    return torch.flip(pts.reshape(1, res * res, res, 3), [2])


class NeuralRayRenderer(nn.Module):
    """Volume path of the renderer; the config mirrors configs/nrvgn_sdf.yaml.
    The fine decoder and aggregator exist so that the full param tree loads;
    the volume path does not run them."""

    def __init__(self, volume_resolution: int = 40, volume_size: float = 0.3,
                 init_s: float = 0.3, use_hierarchical_sampling: bool = True,
                 use_kernels: bool = True):
        super().__init__()
        self.volume_resolution = volume_resolution
        self.volume_size = volume_size
        self.use_kernels = use_kernels
        self.image_encoder = ResUNetLight(3, (1, 2, 6, 4), 32, 16)
        self.init_net = RayFeatInitNet()
        self.vis_encoder = VisEncoder()
        self.dist_decoder = MixtureLogisticsDistDecoder()
        self.agg_net = NeusAggregationNet(init_s=init_s, use_kernels=use_kernels)
        if use_hierarchical_sampling:
            self.fine_dist_decoder = MixtureLogisticsDistDecoder()
            self.fine_agg_net = NeusAggregationNet(init_s=init_s,
                                                   use_kernels=use_kernels)

    def encode_views(self, imgs: torch.Tensor):
        """imgs [V,H,W,3] -> (img_feats, ray_feats), each [V,H/4,W/4,32]."""
        img_feats = self.image_encoder(imgs).contiguous()
        ray_feats = self.vis_encoder(self.init_net(imgs), img_feats)
        return img_feats, ray_feats.contiguous()

    def sample_volume(self, ref, img_feats, ray_feats) -> torch.Tensor:
        """SDF on the res^3 workspace grid -> [res,res,res] (x,y,z order).
        The grid is 1 x res^2 "rays" of res samples, so the ray attention runs
        along each z-column, sampled top-down (z flipped in and back out)."""
        res = self.volume_resolution
        que_pts = volume_query_points(res, self.volume_size, ref["bbox3d_min"])
        prj = project_to_views(ref, que_pts, img_feats, ray_feats,
                               self.use_kernels)
        mean, var, aw = self.dist_decoder(prj["ray_feats"])
        _, visibility, hit = compute_prob(prj["depth"][..., 0], mean, var, aw,
                                          ref["depth_range"])
        prj["vis"] = visibility[..., None] * prj["mask"]
        prj["hit_prob"] = hit[..., None] * prj["mask"]
        que_dir = que_pts.new_tensor([0.0, 0.0, 1.0]).expand_as(que_pts)
        sdf = self.agg_net.sdf(prj, que_dir, que_pts)
        return torch.flip(sdf.reshape(res, res, res), [2])


class GraspNeRF(nn.Module):
    """Renderer + VGN 3D-CNN grasp head; keys `nr_net.*` and `vgn_net.*`."""

    def __init__(self, renderer_cfg: Optional[dict] = None,
                 use_kernels: bool = True):
        super().__init__()
        self.nr_net = NeuralRayRenderer(**(renderer_cfg or {}),
                                        use_kernels=use_kernels)
        self.vgn_net = VGNConvNet()


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init in place, with the JAX package's initialisers:
    lecun-normal kernels (std 1/sqrt(fan_in)), zero biases, unit norm scales,
    and the NeuS variance at its init value (left untouched)."""
    for name, p in module.named_parameters():
        if name.endswith("variance"):
            continue
        if p.dim() >= 2:
            fan_in = math.prod(p.shape[1:])
            p.copy_(torch.randn(p.shape, generator=generator)
                    / math.sqrt(fan_in))
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    return module
