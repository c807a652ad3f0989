"""Generalizable NeRF renderer and grasp network
(graspnerf_tpu/models/renderer.py:42-323).

    6 ref images --ResUNet--> img_feats --+
                 --ResUNet--> ray_feats --+--VisEncoder--> ray_feats
    query rays --inverse-depth samples--> points --project--> epipolar
              gather --dist decoder--> hit/vis --view fuse, geometry head
              --> (rgb, sdf, ∇sdf) --NeuS alpha--> composite; then fine
              samples from the coarse hit probabilities, a second pass
    40^3 grid --same network (SDF only)--> SDF volume
              --3D CNN--> grasp quality / rotation / width

Data contract (float32, channels-last): ref = {imgs [V,H,W,3], poses
[V,3,4] world->cam, Ks [V,3,3], depth_range [V,2], bbox3d_min [3]};
que = {coords [qn,rn,2] (x,y), poses [qn,3,4], Ks [qn,3,3], depth_range
[qn,2], imgs [qn,H,W,3] (optional)}.

Training: `forward(data, train=True, generator=g)` draws the fine samples'
quantiles at random and, with `use_depth_loss`, the depth loss's pixels,
in JAX's order (renderer.py:277-289); the eval path is unchanged. Run it
with grad enabled, never under `torch.inference_mode()`.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from ..ops import geometry
from ..ops.epipolar_gather import epipolar_gather, epipolar_gather_plain
from ..ops.interpolate import interpolate_feats, interpolate_feature_map
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


def draw_pixels(count: int, n: int, generator: torch.Generator,
                device) -> torch.Tensor:
    """n distinct indices of range(count) from `generator` (drawn on the
    generator's device), on `device`: the depth loss's one random draw, kept
    apart so that a test can hand in another library's."""
    return torch.randperm(count, generator=generator,
                          device=generator.device)[:n].to(device)


def resolve_device(device) -> torch.device:
    """`None` means the card. Without one this raises: the port never falls
    back to the CPU on its own; pass device="cpu" for that."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)


class NeuralRayRenderer(nn.Module):
    """The config mirrors configs/nrvgn_sdf.yaml and the JAX dataclass's
    fields of the same names."""

    def __init__(self, depth_sample_num: int = 40,
                 fine_depth_sample_num: int = 40,
                 use_hierarchical_sampling: bool = True,
                 render_rgb: bool = True, render_depth: bool = True,
                 do_sample_volume: bool = True, volume_resolution: int = 40,
                 volume_size: float = 0.3, use_ray_mask: bool = True,
                 ray_mask_view_num: int = 2, ray_mask_point_num: int = 8,
                 depth_loss_coords_num: int = 8192,
                 use_depth_loss: bool = True, init_s: float = 0.3,
                 use_kernels: bool = True):
        super().__init__()
        self.depth_sample_num = depth_sample_num
        self.fine_depth_sample_num = fine_depth_sample_num
        self.use_hierarchical_sampling = use_hierarchical_sampling
        self.render_rgb = render_rgb
        self.render_depth = render_depth
        self.do_sample_volume = do_sample_volume
        self.volume_resolution = volume_resolution
        self.volume_size = volume_size
        self.use_ray_mask = use_ray_mask
        self.ray_mask_view_num = ray_mask_view_num
        self.ray_mask_point_num = ray_mask_point_num
        self.depth_loss_coords_num = depth_loss_coords_num
        self.use_depth_loss = use_depth_loss
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

    def _predict_ray_prob(self, decoder, prj, ref_depth_range, que_dists_inv):
        """Adds the mask-gated `vis` and `hit_prob` to prj; que_dists_inv
        [qn,rn,dn] the rays' intervals, or None for the volume's fixed bins
        (renderer.py:143-159)."""
        mean, var, aw = decoder(prj["ray_feats"])
        interval = None if que_dists_inv is None else que_dists_inv[None]
        _, visibility, hit = compute_prob(prj["depth"][..., 0], mean, var, aw,
                                          ref_depth_range, interval)
        prj["vis"] = visibility[..., None] * prj["mask"]
        prj["hit_prob"] = hit[..., None] * prj["mask"]
        return prj

    def render_by_depth(self, que_depth, que, ref, img_feats, ray_feats,
                        is_fine: bool):
        """One render pass at the depths que_depth [qn,rn,dn]
        (renderer.py:161-197)."""
        dist_decoder = self.fine_dist_decoder if is_fine else self.dist_decoder
        agg_net = self.fine_agg_net if is_fine else self.agg_net

        que_dists_inv = geometry.depth2inv_dists(que_depth, que["depth_range"])
        que_pts, que_dir = geometry.depth2points(
            que["coords"], que["poses"], que["Ks"], que_depth)
        prj = project_to_views(ref, que_pts, img_feats, ray_feats,
                               self.use_kernels)
        prj = self._predict_ray_prob(dist_decoder, prj, ref["depth_range"],
                                     que_dists_inv)
        agg = agg_net(prj, que_dir, que_pts, geometry.depth2dists(que_depth))

        hit_prob = geometry.alpha2hit_prob(agg["alpha"])
        out = {"alpha_values": agg["alpha"], "colors_nr": agg["colors"],
               "hit_prob_nr": hit_prob,
               "pixel_colors_nr": geometry.composite(hit_prob, agg["colors"]),
               "sdf_values": agg["sdf"],
               "sdf_gradient_error": agg["grad_error"], "s": agg["s"]}
        if "imgs" in que:
            out["pixel_colors_gt"] = interpolate_feats(
                que["imgs"], que["coords"], align_corners=True)
        if self.use_ray_mask:
            m = torch.sum(prj["mask"], 0) > self.ray_mask_view_num  # qn,rn,dn,1
            out["ray_mask"] = (torch.sum(m, 2) > self.ray_mask_point_num)[..., 0]
        if self.render_depth:
            out["render_depth"] = torch.sum(hit_prob * que_depth, -1)
        return out

    def render_rays(self, que, ref, img_feats, ray_feats, generator=None):
        """Coarse pass, then fine samples from its hit probabilities (no
        gradient flows into them) and a second pass under the `_fine` keys
        (renderer.py:199-216). With a generator the fine quantiles are drawn
        at random; the coarse samples stay deterministic, as in JAX."""
        _, rn, _ = que["coords"].shape
        que_depth = geometry.sample_depth(que["depth_range"], rn,
                                          self.depth_sample_num)
        out = self.render_by_depth(que_depth, que, ref, img_feats, ray_feats,
                                   False)
        if self.use_hierarchical_sampling:
            fine_depth = geometry.sample_fine_depth(
                que_depth, out["hit_prob_nr"].detach(), que["depth_range"],
                self.fine_depth_sample_num, generator)
            fine_depth = torch.sort(fine_depth, -1).values
            fine = self.render_by_depth(fine_depth, que, ref, img_feats,
                                        ray_feats, True)
            out.update({k + "_fine": v for k, v in fine.items()})
        return out

    def sample_volume(self, ref, img_feats, ray_feats) -> torch.Tensor:
        """SDF on the res^3 workspace grid -> [res,res,res] (x,y,z order).
        The grid is 1 x res^2 "rays" of res samples, so the ray attention runs
        along each z-column, sampled top-down (z flipped in and back out)."""
        res = self.volume_resolution
        que_pts = volume_query_points(res, self.volume_size, ref["bbox3d_min"])
        prj = project_to_views(ref, que_pts, img_feats, ray_feats,
                               self.use_kernels)
        prj = self._predict_ray_prob(self.dist_decoder, prj,
                                     ref["depth_range"], None)
        que_dir = que_pts.new_tensor([0.0, 0.0, 1.0]).expand_as(que_pts)
        sdf = self.agg_net.sdf(prj, que_dir, que_pts)
        return torch.flip(sdf.reshape(res, res, res), [2])

    def predict_mean_for_depth_loss(self, ref, ray_feats,
                                    generator: torch.Generator):
        """The mixture means at n = min(depth_loss_coords_num, h*w) distinct
        random pixels of every view, for the depth loss
        (renderer.py:244-265): {depth_coords [V,n,2] (x, y), depth_mean_all
        [V,n,2], depth_mean, depth_mean_2 [V,n], and the fine decoder's
        depth_mean_fine, depth_mean_fine_2}. The coordinates are proper
        (x, y) over the whole image (README.md:101-103)."""
        V, h, w, _ = ref["imgs"].shape
        n = min(self.depth_loss_coords_num, h * w)
        idx = draw_pixels(h * w, n, generator, ray_feats.device)
        coords = torch.stack([(idx % w).to(torch.float32),
                              (idx // w).to(torch.float32)], -1)
        coords = coords[None].expand(V, n, 2)
        mask = coords.new_ones((V, n))
        feats = interpolate_feature_map(ray_feats, coords, mask, h, w)
        mean = self.dist_decoder.predict_mean(feats)
        out = {"depth_coords": coords, "depth_mean_all": mean,
               "depth_mean": mean[..., 0], "depth_mean_2": mean[..., 1]}
        if self.use_hierarchical_sampling:
            fine = self.fine_dist_decoder.predict_mean(feats)
            out["depth_mean_fine"] = fine[..., 0]
            out["depth_mean_fine_2"] = fine[..., 1]
        return out

    def forward(self, data: Dict[str, Dict[str, torch.Tensor]],
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """data = {"ref": ..., "que": ... (optional)} -> the render keys
        (coarse, and `_fine`) when there is a `que`, `volume`, and with a
        generator and `use_depth_loss` the depth-loss means
        (renderer.py:268-290). `train` with a generator draws the fine
        quantiles at random, before the depth-loss pixels, as JAX splits
        its key."""
        ref, que = data["ref"], data.get("que")
        img_feats, ray_feats = self.encode_views(ref["imgs"])
        out = {}
        if self.render_rgb and que is not None:
            out = self.render_rays(que, ref, img_feats, ray_feats,
                                   generator if train else None)
        if self.do_sample_volume:
            out["volume"] = self.sample_volume(ref, img_feats, ray_feats)
        if self.use_depth_loss and generator is not None:
            out.update(self.predict_mean_for_depth_loss(ref, ray_feats,
                                                        generator))
        return out


class GraspNeRF(nn.Module):
    """Renderer + VGN 3D-CNN grasp head; keys `nr_net.*` and `vgn_net.*`."""

    def __init__(self, renderer_cfg: Optional[dict] = None,
                 use_kernels: bool = True):
        super().__init__()
        self.nr_net = NeuralRayRenderer(**(renderer_cfg or {}),
                                        use_kernels=use_kernels)
        self.vgn_net = VGNConvNet()

    def forward(self, data, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """The renderer's outputs plus `vgn_pred_full` = (qual, rot, width)
        [1,res,res,res,C] on its volume and, for data["grasp_index"] [n,3]
        voxel indices, `vgn_pred` at them (renderer.py:310-323)."""
        out = self.nr_net(data, train, generator)
        qual, rot, width = self.vgn_net(out["volume"][None, ..., None])
        out["vgn_pred_full"] = (qual, rot, width)
        if "grasp_index" in data:
            i, j, k = data["grasp_index"].unbind(-1)
            out["vgn_pred"] = (qual[0, i, j, k, 0], rot[0, i, j, k, :],
                               width[0, i, j, k, 0])
        return out


def load_graspnerf(params: Mapping[str, torch.Tensor], device=None,
                   renderer_cfg: Optional[dict] = None,
                   use_kernels: bool = True) -> GraspNeRF:
    """A GraspNeRF in eval mode with `params` (torch keys, e.g. from
    `convert.flax_to_state_dict`) loaded strictly, on `device`: the card
    when None, raising without one. It computes in float32: on a card this
    turns TF32 off for matmuls and cuDNN convolutions, a process-wide
    PyTorch setting. `use_kernels` False runs the kernels' plain versions
    on the card; it exists to hold the kernels against them. For inference
    run the model under `torch.no_grad()`, as the planner does (the render
    path's ∇sdf takes its own local autograd); with grad enabled its
    outputs are differentiable, for training (`train.create_train_state`).
    Never under `torch.inference_mode()`."""
    device = resolve_device(device)
    float32_on(device)
    model = GraspNeRF(renderer_cfg, use_kernels=use_kernels)
    model.load_state_dict(params, strict=True)
    return model.to(device).eval()


def float32_on(device: torch.device) -> None:
    """On a card, matmuls and cuDNN convolutions in full float32 (TF32 off),
    a process-wide PyTorch setting."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


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
