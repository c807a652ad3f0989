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

`compute_dtype` "bfloat16" runs the model in bfloat16 as the JAX renderer
does (renderer.py:94-140): parameters float32, every layer in bfloat16
(models/layers.py), the encoders' outputs cast back to float32, the gather
on the images and feature maps rounded to bfloat16 once per scene
(`gather_maps`, as `pack_feature_maps(dtype)` packs them once per call) with
float32 interpolation; geometry, compositing, the SDF, the depth and the
grasp head's outputs float32.

Training: `forward(data, train=True, generator=g)` draws the fine samples'
quantiles at random and, with `use_depth_loss`, the depth loss's pixels,
in JAX's order (renderer.py:277-289); the eval path is unchanged. Run it
with grad enabled, never under `torch.inference_mode()`.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from .. import tracing
from ..device import resolve_device
from ..ops import geometry
from ..ops.epipolar_gather import epipolar_gather, epipolar_gather_plain
from ..ops.interpolate import interpolate_feats, interpolate_feature_map
from ..ops.tsdf import grid_points
from .aggregator import NeusAggregationNet, gradient_error
from .dist_decoder import MixtureLogisticsDistDecoder, compute_prob
from .grasp_head import VGNConvNet
from .layers import torch_dtype
from .nn_blocks import ResUNetLight, RayFeatInitNet, VisEncoder

# the spans of the views' encoding and of the SDF volume (tracing.py)
ENCODE, ENCODE_IMAGE, ENCODE_RAYINIT, ENCODE_VIS = map(tracing.span, (
    "encode", "encode.image", "encode.rayinit", "encode.vis"))
VOLUME, VOLUME_PROJECT, VOLUME_GATHER, VOLUME_DECODE, VOLUME_FUSE = map(
    tracing.span, ("volume", "volume.project", "volume.gather",
                   "volume.decode", "volume.fuse"))


def project_to_views(ref: Dict[str, torch.Tensor], que_pts: torch.Tensor,
                     maps, use_kernels: bool = True):
    """Project query points [qn,rn,dn,3] into every view and gather from
    maps = (imgs [V,H,W,3], img_feats, ray_feats [V,H/4,W/4,32]), all of one
    dtype (`NeuralRayRenderer.gather_maps`). Returns [V,qn,rn,dn,C]
    tensors: dir(3), pts(2), depth(1), mask(1), ray_feats(32),
    rgb_feats(35) = rgb | img_feats (the JAX dict's `rgb` and `img_feats`,
    already concatenated as the aggregator uses them); rgb_feats in the
    maps' dtype, the others float32. ray_feats is the float32 blend, as
    JAX's gather returns it, so the bfloat16 gradients of its two consumers
    (the dist decoder, renderer.py:146, and the prob embedding,
    aggregator.py:95-96) add in float32, and the gather's backward reads
    that sum. rgb_feats' consumers round it to bfloat16 once
    (ibrnet.py:212), so its gradients add in bfloat16 in both. Its halves,
    `project_views` and `gather_views`, are the volume's `volume.project`
    and `volume.gather` spans."""
    return gather_views(ref, maps, project_views(ref, que_pts), use_kernels)


def project_views(ref: Dict[str, torch.Tensor], que_pts: torch.Tensor):
    """The projection of `project_to_views`: (que_pts, xy [V,P,2], depth
    [V,P], valid [V,P]) for the P = qn*rn*dn points."""
    _, h, w, _ = ref["imgs"].shape
    xy, depth, valid = geometry.project_points(que_pts.reshape(-1, 3),
                                               ref["poses"], ref["Ks"], h, w)
    xy = xy.contiguous()   # einsum may hand back a permuted layout
    return que_pts, xy, depth, valid


def gather_views(ref: Dict[str, torch.Tensor], maps, projected,
                 use_kernels: bool = True):
    """The rest of `project_to_views` at `project_views`' result: the
    gather, then the view directions and the dict."""
    que_pts, xy, depth, valid = projected
    qn, rn, dn, _ = que_pts.shape
    V = xy.shape[0]
    gather = epipolar_gather if use_kernels else epipolar_gather_plain
    rgb_feats, prj_ray_feats = gather(*maps, xy, valid)

    def r(x):
        return x.reshape(V, qn, rn, dn, -1)

    dirs = geometry.view_directions(que_pts.reshape(-1, 3), ref["poses"])
    return {"dir": r(dirs), "pts": r(xy), "depth": r(depth),
            "mask": r(valid.to(torch.float32)),
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


class NeuralRayRenderer(nn.Module):
    """The config mirrors configs/nrvgn_sdf.yaml and the JAX dataclass's
    fields of the same names; compute_dtype "float32" | "bfloat16"."""

    def __init__(self, depth_sample_num: int = 40,
                 fine_depth_sample_num: int = 40,
                 use_hierarchical_sampling: bool = True,
                 render_rgb: bool = True, render_depth: bool = True,
                 do_sample_volume: bool = True, volume_resolution: int = 40,
                 volume_size: float = 0.3, use_ray_mask: bool = True,
                 ray_mask_view_num: int = 2, ray_mask_point_num: int = 8,
                 depth_loss_coords_num: int = 8192,
                 use_depth_loss: bool = True, init_s: float = 0.3,
                 compute_dtype: str = "float32", use_kernels: bool = True):
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
        self.compute_dtype = compute_dtype
        # the space axis's `parallel.SpaceSplit` (JAX's `space_axis`), set
        # by a Trainer on a mesh: None renders every ray on this process
        self.space = None
        d = self.dtype = torch_dtype(compute_dtype)
        self.image_encoder = ResUNetLight(3, (1, 2, 6, 4), 32, 16, d)
        self.init_net = RayFeatInitNet(d)
        self.vis_encoder = VisEncoder(d)
        self.dist_decoder = MixtureLogisticsDistDecoder(dtype=d)
        self.agg_net = NeusAggregationNet(init_s=init_s,
                                          use_kernels=use_kernels, dtype=d)
        if use_hierarchical_sampling:
            self.fine_dist_decoder = MixtureLogisticsDistDecoder(dtype=d)
            self.fine_agg_net = NeusAggregationNet(
                init_s=init_s, use_kernels=use_kernels, dtype=d)

    def encode_views(self, imgs: torch.Tensor):
        """imgs [V,H,W,3] -> (img_feats, ray_feats), each [V,H/4,W/4,32],
        float32 whatever the compute dtype (renderer.py:133-140)."""
        with ENCODE:
            with ENCODE_IMAGE:
                img_feats = self.image_encoder(imgs).contiguous()
            with ENCODE_RAYINIT:
                init = self.init_net(imgs)
            with ENCODE_VIS:
                ray_feats = self.vis_encoder(init, img_feats)
            return img_feats.float(), ray_feats.contiguous().float()

    def gather_maps(self, imgs, img_feats, ray_feats):
        """The gather's maps, once per scene: the images and feature maps
        in the compute dtype (pack_feature_maps(dtype), fused_gather.py:
        43-64); unchanged in float32."""
        return tuple(t.to(self.dtype) for t in (imgs, img_feats, ray_feats))

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
                        is_fine: bool, maps=None):
        """One render pass at the depths que_depth [qn,rn,dn]
        (renderer.py:161-197); maps: `gather_maps`' result, made here when
        None. With a `space` split the pass (projection, dist decoder,
        aggregator) runs this rank's rays, and their outputs are joined
        back to all rn rays before the alpha's composite (renderer.py:171)."""
        dist_decoder = self.fine_dist_decoder if is_fine else self.dist_decoder
        agg_net = self.fine_agg_net if is_fine else self.agg_net

        que_dists_inv = geometry.depth2inv_dists(que_depth, que["depth_range"])
        que_pts, que_dir = geometry.depth2points(
            que["coords"], que["poses"], que["Ks"], que_depth)
        que_dists = geometry.depth2dists(que_depth)
        rn = que_pts.shape[1]
        if self.space is not None:
            rows = self.space.rows(rn)
            que_dists_inv, que_pts, que_dir, que_dists = (
                t[:, rows] for t in (que_dists_inv, que_pts, que_dir,
                                     que_dists))
        if maps is None:
            maps = self.gather_maps(ref["imgs"], img_feats, ray_feats)
        prj = project_to_views(ref, que_pts, maps, self.use_kernels)
        prj = self._predict_ray_prob(dist_decoder, prj, ref["depth_range"],
                                     que_dists_inv)
        agg = agg_net(prj, que_dir, que_pts, que_dists)
        if self.use_ray_mask:
            m = torch.sum(prj["mask"], 0) > self.ray_mask_view_num  # qn,rn,dn,1
            agg["ray_mask"] = (torch.sum(m, 2) > self.ray_mask_point_num)[..., 0]
        if self.space is not None:
            for k in ("sdf", "colors", "alpha", "grad", "ray_mask"):
                if k in agg:
                    agg[k] = self.space.join(agg[k], rn)
            # the one term that mixes rays: its mean over all of them
            agg["grad_error"] = gradient_error(agg["grad"])

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
            out["ray_mask"] = agg["ray_mask"]
        if self.render_depth:
            out["render_depth"] = torch.sum(hit_prob * que_depth, -1)
        return out

    def render_rays(self, que, ref, img_feats, ray_feats, generator=None,
                    maps=None):
        """Coarse pass, then fine samples from its hit probabilities (no
        gradient flows into them) and a second pass under the `_fine` keys
        (renderer.py:199-216). With a generator the fine quantiles are drawn
        at random; the coarse samples stay deterministic, as in JAX. maps:
        `gather_maps`' result, made here when None."""
        _, rn, _ = que["coords"].shape
        if maps is None:
            maps = self.gather_maps(ref["imgs"], img_feats, ray_feats)
        que_depth = geometry.sample_depth(que["depth_range"], rn,
                                          self.depth_sample_num)
        out = self.render_by_depth(que_depth, que, ref, img_feats, ray_feats,
                                   False, maps)
        if self.use_hierarchical_sampling:
            fine_depth = geometry.sample_fine_depth(
                que_depth, out["hit_prob_nr"].detach(), que["depth_range"],
                self.fine_depth_sample_num, generator)
            fine_depth = torch.sort(fine_depth, -1).values
            fine = self.render_by_depth(fine_depth, que, ref, img_feats,
                                        ray_feats, True, maps)
            out.update({k + "_fine": v for k, v in fine.items()})
        return out

    def sample_volume(self, ref, img_feats, ray_feats,
                      maps=None) -> torch.Tensor:
        """SDF on the res^3 workspace grid -> [res,res,res] (x,y,z order),
        float32. The grid is 1 x res^2 "rays" of res samples, so the ray
        attention runs along each z-column, sampled top-down (z flipped in
        and back out). maps: `gather_maps`' result, made here when None.
        With a `space` split this rank evaluates its share of the columns
        and the SDF is joined back (renderer.py:229)."""
        res = self.volume_resolution
        with VOLUME:
            if maps is None:
                maps = self.gather_maps(ref["imgs"], img_feats, ray_feats)
            with VOLUME_PROJECT:
                que_pts = volume_query_points(res, self.volume_size,
                                              ref["bbox3d_min"])
                if self.space is not None:
                    que_pts = que_pts[:, self.space.rows(res * res)]
                projected = project_views(ref, que_pts)
            with VOLUME_GATHER:
                prj = gather_views(ref, maps, projected, self.use_kernels)
            with VOLUME_DECODE:
                prj = self._predict_ray_prob(self.dist_decoder, prj,
                                             ref["depth_range"], None)
            with VOLUME_FUSE:
                que_dir = que_pts.new_tensor([0.0, 0.0, 1.0]).expand_as(que_pts)
                sdf = self.agg_net.sdf(prj, que_dir, que_pts)
            if self.space is not None:
                sdf = self.space.join(sdf, res * res)
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
        maps = self.gather_maps(ref["imgs"], img_feats, ray_feats)
        out = {}
        if self.render_rgb and que is not None:
            out = self.render_rays(que, ref, img_feats, ray_feats,
                                   generator if train else None, maps)
        if self.do_sample_volume:
            out["volume"] = self.sample_volume(ref, img_feats, ray_feats,
                                               maps)
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
        self.vgn_net = VGNConvNet(self.nr_net.dtype)

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
    when None, raising without one. It computes in renderer_cfg's
    `compute_dtype` (float32 by default; the same state dict serves
    "bfloat16"); on a card this turns TF32 off for float32 matmuls and cuDNN
    convolutions, a process-wide PyTorch setting. `use_kernels` False runs the kernels' plain versions
    on the card; it exists to hold the kernels against them. For inference
    run the model under `torch.no_grad()`, as the planner does (the render
    path's ∇sdf takes its own local autograd); with grad enabled its
    outputs are differentiable, for training (`train.create_train_state`).
    Never under `torch.inference_mode()`."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    float32_on(device)
    model = GraspNeRF(renderer_cfg, use_kernels=use_kernels)
    model.load_state_dict(params, strict=True)
    model = model.to(device).eval()
    tracing.COUNTERS["model_load_s"] += time.perf_counter() - t0
    return model


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
