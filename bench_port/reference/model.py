"""GraspNeRF's modules in plain float32, under the port's state-dict keys:
the ResUNet image encoder, the ray-feature encoders, the mixture-of-
logistics distance decoder, the IBRNet-NeuS aggregation (its view fuse
written as Linear layers over the six views), the NeuS alpha, the SDF
volume and the VGN grasp head. Every Linear, convolution and attention
product reads its operands through the model's `Precision`."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import ops
from .precision import Precision

BBOX_MIN = (-0.15, -0.15, -0.0503)


class _Rounded:
    prec = Precision("float32")


class Linear(nn.Linear, _Rounded):
    def forward(self, x):
        return self.prec.out(F.linear(self.prec(x), self.prec(self.weight),
                                      self.bias))


class Conv2d(nn.Conv2d, _Rounded):
    def forward(self, x):
        return self.prec.out(self._conv_forward(
            self.prec(x), self.prec(self.weight), self.bias))


class Conv3d(nn.Conv3d, _Rounded):
    def forward(self, x):
        return self.prec.out(self._conv_forward(
            self.prec(x), self.prec(self.weight), self.bias))


def set_precision(model: nn.Module, prec: Precision) -> nn.Module:
    for m in model.modules():
        if isinstance(m, _Rounded):
            m.prec = prec
    return model


def conv(cin, cout, k, stride=1, padding=None, bias=True, reflect=True):
    p = (k - 1) // 2 if padding is None else padding
    return Conv2d(cin, cout, k, stride, p, bias=bias,
                  padding_mode="reflect" if reflect else "zeros")


class InstanceNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=1e-5)


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1, down=False):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, stride, bias=False)
        self.bn1 = InstanceNorm(planes)
        self.conv2 = conv(planes, planes, 3, bias=False)
        self.bn2 = InstanceNorm(planes)
        self.downsample = (nn.Sequential(conv(cin, planes, 1, stride,
                                              bias=False),
                                         InstanceNorm(planes))
                           if down else None)

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None
                             else self.downsample(x)))


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Sequential(InstanceNorm(cin), nn.ReLU(),
                                  conv(cin, cout, 3, bias=False),
                                  InstanceNorm(cout), nn.ReLU(),
                                  conv(cout, cout, 3, bias=False))
        self.short_cut = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        return (x if self.short_cut is None else self.short_cut(x)) \
            + self.conv(x)


class ConvINElu(nn.Module):
    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        self.conv = conv(cin, cout, k, stride)
        self.bn = InstanceNorm(cout)

    def forward(self, x):
        return F.elu(self.bn(self.conv(x)))


class UpConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvINElu(cin, cout, 3)

    def forward(self, x):
        h, w = x.shape[-2:]
        return self.conv(F.interpolate(x, size=(2 * h, 2 * w),
                                       mode="bilinear", align_corners=True))


class ResUNetLight(nn.Module):
    """[B,C,H,W] -> [B,32,H/4,W/4]; stage widths 32/64/128."""

    def __init__(self, blocks=(2, 3, 6), inplanes=32):
        super().__init__()
        self.conv1 = conv(3, inplanes, 7, 2, padding=3, bias=False)
        self.bn1 = InstanceNorm(inplanes)
        widths = (inplanes, 32, 64, 128)
        for i, n in enumerate(blocks):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                BasicBlock(widths[i], widths[i + 1], 2, True),
                *[BasicBlock(widths[i + 1], widths[i + 1])
                  for _ in range(1, n)]))
        self.upconv3 = UpConv(128, 64)
        self.iconv3 = ConvINElu(128, 64, 3)
        self.upconv2 = UpConv(64, 32)
        self.iconv2 = ConvINElu(64, 32, 3)
        self.out_conv = conv(32, 32, 1, reflect=False)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        y = self.iconv3(torch.cat([self.upconv3(x3), x2], 1))
        y = self.iconv2(torch.cat([self.upconv2(y), x1], 1))
        return self.out_conv(y)


class RayFeatInitNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.res_net = ResUNetLight((2, 3, 6), 32)
        self.out_conv = nn.Sequential(conv(32, 32, 3, bias=False),
                                      ResidualBlock(32, 32),
                                      conv(32, 32, 1, bias=False))

    def forward(self, x):
        return self.out_conv(self.res_net(x))


class VisEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.out_conv = nn.Sequential(conv(64, 32, 3, bias=False),
                                      ResidualBlock(32, 32),
                                      ResidualBlock(32, 32),
                                      conv(32, 32, 1, bias=False))

    def forward(self, ray_feats, img_feats):
        return self.out_conv(torch.cat([img_feats, ray_feats], 1))


def mlp(dims, acts, d_in):
    """Linears named "0", "2", ... each followed by its activation."""
    layers = []
    for d, a in zip(dims, acts):
        layers += [Linear(d_in, d), {"elu": nn.ELU(), "sigmoid": nn.Sigmoid(),
                                     None: nn.Identity()}[a]]
        d_in = d
    return nn.Sequential(*(layers[:-1] if acts[-1] is None else layers))


class DistDecoder(nn.Module):
    """feats [...,32] -> mixture (mean, var, weight) of the hit depth."""

    def __init__(self):
        super().__init__()
        self.mean_decoder = mlp((32, 32, 2), ("elu", "elu", None), 32)
        self.var_decoder = mlp((32, 32, 2), ("elu", "elu", None), 32)
        self.aw_decoder = mlp((32, 32, 1), ("elu", "elu", None), 32)

    def forward(self, feats):
        return (F.softplus(self.mean_decoder(feats)),
                F.softplus(self.var_decoder(feats)) + 0.05,
                torch.sigmoid(self.aw_decoder(feats)))

    def mean(self, feats):
        return F.softplus(self.mean_decoder(feats))


def hit_and_visibility(depth, mean, var, aw, depth_range, interval=None):
    near, far = ops.near_far(depth, depth_range, interval)
    mix = torch.cat([aw, 1.0 - aw], -1)
    cdf0 = 0.5 + 0.5 * torch.tanh((near[..., None] - mean) * var)
    cdf1 = 0.5 + 0.5 * torch.tanh((far[..., None] - mean) * var)
    return (torch.sum((1.0 - cdf0) * mix, -1),
            torch.sum((cdf1 - cdf0) * mix, -1))


class Attention(nn.Module):
    """Post-LN 4-head attention along a ray's samples; masked query rows."""

    def __init__(self, heads=4, d=16, dk=4):
        super().__init__()
        self.heads, self.dk = heads, dk
        self.w_qs = Linear(d, heads * dk, bias=False)
        self.w_ks = Linear(d, heads * dk, bias=False)
        self.w_vs = Linear(d, heads * dk, bias=False)
        self.fc = Linear(heads * dk, d, bias=False)
        self.layer_norm = nn.LayerNorm(d, eps=1e-6)
        self.prec = Precision("float32")

    def forward(self, x, mask):
        B, L, _ = x.shape
        q, k, v = (f(x).reshape(B, L, self.heads, self.dk).transpose(1, 2)
                   for f in (self.w_qs, self.w_ks, self.w_vs))
        p = self.prec
        a = p.out(torch.matmul(p(q / self.dk ** 0.5), p(k.transpose(-1, -2))))
        a = a.masked_fill(mask[:, None] == 0, -1e9)
        out = p.out(torch.matmul(p(torch.softmax(a, -1)), p(v)))
        out = out.transpose(1, 2).reshape(B, L, -1)
        return self.layer_norm(self.fc(out) + x)


def positional_table(n: int, d: int = 16):
    pos = np.arange(n)[:, None]
    j = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, 2 * (j // 2) / d)
    return np.where(j % 2 == 0, np.sin(angle), np.cos(angle))[None].astype(
        np.float32)


def embed_points(pts, multires: int = 3):
    out = [pts]
    for i in range(multires):
        out += [torch.sin(pts * 2.0 ** i), torch.cos(pts * 2.0 ** i)]
    return torch.cat(out, -1)


def weighted_mean_var(x, w):
    mean = torch.sum(x * w, 0)
    return mean, torch.sum(w * (x - mean[None]) ** 2, 0)


class IBRNetNeus(nn.Module):
    def __init__(self):
        super().__init__()
        self.ray_dir_fc = mlp((16, 35), ("elu", "elu"), 4)
        self.base_fc = mlp((64, 32), ("elu", "elu"), 35 * 5 + 32)
        self.vis_fc = mlp((32, 33), ("elu", "elu"), 32)
        self.vis_fc2 = mlp((32, 1), ("elu", "sigmoid"), 32)
        self.geometry_fc = mlp((64, 16), ("elu", "elu"), 65 + 21)
        self.ray_attention = Attention()
        self.rgb_fc = mlp((16, 8, 1), ("elu", "elu", None), 37)
        self.neuray_fc = mlp((8, 1), ("elu", None), 32)
        self.out_geometry_fc = nn.Sequential(Linear(16, 16), Linear(16, 1))

    def view_fuse(self, rgbf, neur, rdiff, mask):
        """[V,N,C] inputs -> (feat_const [N,65], num_valid [N,1], x [V,N,32],
        vis [V,N,1])."""
        rf = rgbf + self.ray_dir_fc(rdiff)
        weight = mask / (torch.sum(mask, 0, keepdim=True) + 1e-8)
        w0 = torch.sigmoid(self.neuray_fc(neur)) * weight
        mean0, var0 = weighted_mean_var(rf, w0)
        mean1, var1 = weighted_mean_var(rf, weight)
        gf = torch.cat([mean0, var0, mean1, var1], -1)
        V = rgbf.shape[0]
        x = self.base_fc(torch.cat([gf[None].expand(V, -1, -1), rf, neur], -1))
        xv = self.vis_fc(x * weight)
        x = x + xv[..., :32]
        vis = torch.sigmoid(xv[..., 32:]) * mask
        vis = self.vis_fc2(x * vis) * mask
        weight2 = vis / (torch.sum(vis, 0, keepdim=True) + 1e-8)
        mean, var = weighted_mean_var(x, weight2)
        return (torch.cat([mean, var, torch.mean(weight2, 0)], -1),
                torch.sum(mask, 0), x, vis)

    def geometry(self, feat_const, pts, num_valid):
        R, D, _ = feat_const.shape
        pos = torch.from_numpy(positional_table(D)).to(feat_const.device)
        g = torch.cat([feat_const, embed_points(pts).reshape(R, D, -1)], -1)
        g = self.ray_attention(self.geometry_fc(g) + pos,
                               (num_valid > 1).float())
        sdf = torch.clamp(self.out_geometry_fc(g), -1.0, 1.0)
        return torch.where(num_valid < 1, torch.ones_like(sdf), sdf)

    def geometry_and_grad(self, feat_const, pts, num_valid):
        """(sdf, d sdf / d points), the gradient with its graph when grad is
        enabled (the eikonal term's double backward)."""
        if torch.is_grad_enabled():
            p = pts.detach().requires_grad_()
            sdf = self.geometry(feat_const, p, num_valid)
            grad, = torch.autograd.grad(sdf, p, torch.ones_like(sdf),
                                        create_graph=True)
            return sdf, grad
        with torch.enable_grad():
            p = pts.detach().requires_grad_()
            sdf = self.geometry(feat_const.detach(), p, num_valid)
            grad, = torch.autograd.grad(sdf, p, torch.ones_like(sdf))
        return sdf.detach(), grad

    def blend(self, rgb, x, vis, rdiff, mask):
        h = self.rgb_fc(torch.cat([x, vis, rdiff], -1))
        h = h.masked_fill(mask == 0, -1e9)
        return torch.sum(rgb * torch.softmax(h, 0), 0)


class SingleVariance(nn.Module):
    def __init__(self, init_val=0.3):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(init_val))


class Aggregator(nn.Module):
    def __init__(self):
        super().__init__()
        self.prob_embed = nn.Sequential(Linear(34, 32), nn.ReLU(),
                                        Linear(32, 32))
        self.agg_impl = IBRNetNeus()
        self.deviation_network = SingleVariance()

    def fuse_inputs(self, prj, que_dir):
        V = prj["dir"].shape[0]
        pe = self.prob_embed(torch.cat([prj["ray_feats"],
                                        (prj["hit_prob"] - 0.5) * 2,
                                        (prj["vis"] - 0.5) * 2], -1))
        diff = prj["dir"] - que_dir[None]
        dot = torch.sum(prj["dir"] * que_dir[None], -1, keepdim=True)

        def vnc(t):
            return t.reshape(V, -1, t.shape[-1])
        return (vnc(prj["rgb_feats"]), vnc(pe),
                torch.cat([diff, dot], -1).reshape(V, -1, 4),
                vnc(prj["mask"]))

    def sdf(self, prj, que_dir, que_pts):
        qn, rn, dn, _ = que_pts.shape
        fc, nv, _, _ = self.agg_impl.view_fuse(*self.fuse_inputs(prj,
                                                                 que_dir))
        sdf = self.agg_impl.geometry(fc.reshape(qn * rn, dn, -1), que_pts,
                                     nv.reshape(qn * rn, dn, 1))
        return sdf.reshape(qn, rn, dn)

    def forward(self, prj, que_dir, que_pts, que_dists):
        qn, rn, dn, _ = que_pts.shape
        rgbf, neur, rdiff, mask = self.fuse_inputs(prj, que_dir)
        impl = self.agg_impl
        fc, nv, x, vis = impl.view_fuse(rgbf, neur, rdiff, mask)
        sdf, grad = impl.geometry_and_grad(fc.reshape(qn * rn, dn, -1),
                                           que_pts, nv.reshape(qn * rn, dn, 1))
        colors = impl.blend(rgbf[..., :3], x, vis, rdiff, mask)
        sdf = sdf[..., 0].reshape(qn, rn, dn)
        inv_s = torch.clamp(torch.exp(self.deviation_network.variance * 10),
                            1e-6, 1e6)
        cos = torch.sum(-que_dir * grad, -1)
        step = -F.relu(-cos) * que_dists * 0.5
        prev_cdf = torch.sigmoid((sdf - step) * inv_s)
        next_cdf = torch.sigmoid((sdf + step) * inv_s)
        alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5),
                            0.0, 1.0)
        eikonal = torch.mean((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2)
        return {"sdf": sdf, "colors": colors.reshape(qn, rn, dn, 3),
                "alpha": alpha, "eikonal": eikonal}


class Renderer(nn.Module):
    """The neural-ray renderer and SDF volume; cfg: the configuration's
    renderer keys."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ResUNetLight((1, 2, 6), 16)
        self.init_net = RayFeatInitNet()
        self.vis_encoder = VisEncoder()
        self.dist_decoder = DistDecoder()
        self.agg_net = Aggregator()
        self.fine_dist_decoder = DistDecoder()
        self.fine_agg_net = Aggregator()

    def encode(self, imgs):
        x = imgs.permute(0, 3, 1, 2)
        img_feats = self.image_encoder(x)
        ray_feats = self.vis_encoder(self.init_net(x), img_feats)
        return (img_feats.permute(0, 2, 3, 1).contiguous(),
                ray_feats.permute(0, 2, 3, 1).contiguous())

    def project(self, ref, pts, img_feats, ray_feats):
        """Points [qn,rn,dn,3] in every view: the epipolar gather."""
        qn, rn, dn, _ = pts.shape
        flat = pts.reshape(-1, 3)
        V, h, w, _ = ref["imgs"].shape
        xy, depth, valid = ops.project_points(flat, ref["poses"], ref["Ks"],
                                              h, w)
        rgb = ops.fetch_masked(ref["imgs"], xy, valid, h, w)
        img_f = ops.fetch_masked(img_feats, xy, valid, h, w)
        ray_f = ops.fetch_masked(ray_feats, xy, valid, h, w)

        def r(t):
            return t.reshape(V, qn, rn, dn, -1)
        return {"dir": r(ops.view_directions(flat, ref["poses"])),
                "depth": r(depth), "mask": r(valid.float()),
                "ray_feats": r(ray_f),
                "rgb_feats": r(torch.cat([rgb, img_f], -1))}

    def probabilities(self, decoder, prj, depth_range, interval):
        mean, var, aw = decoder(prj["ray_feats"])
        vis, hit = hit_and_visibility(prj["depth"][..., 0], mean, var, aw,
                                      depth_range, interval)
        prj["vis"] = vis[..., None] * prj["mask"]
        prj["hit_prob"] = hit[..., None] * prj["mask"]
        return prj

    def render_pass(self, depth, que, ref, img_feats, ray_feats, fine):
        decoder = self.fine_dist_decoder if fine else self.dist_decoder
        agg = self.fine_agg_net if fine else self.agg_net
        interval = ops.depth2dists(ops.to_inv_norm(depth, que["depth_range"]))
        pts, que_dir = ops.depth2points(que["coords"], que["poses"],
                                        que["Ks"], depth)
        prj = self.project(ref, pts, img_feats, ray_feats)
        prj = self.probabilities(decoder, prj, ref["depth_range"],
                                 interval[None])
        out = agg(prj, que_dir, pts, ops.depth2dists(depth))
        m = torch.sum(prj["mask"], 0) > self.cfg["ray_mask_view_num"]
        ray_mask = (torch.sum(m, 2) > self.cfg["ray_mask_point_num"])[..., 0]
        hit = ops.alpha2hit_prob(out["alpha"])
        return {"pixel": ops.composite(hit, out["colors"]), "hit": hit,
                "ray_mask": ray_mask, "eikonal": out["eikonal"]}

    def render(self, que, ref, img_feats, ray_feats, generator=None):
        rn = que["coords"].shape[1]
        depth = ops.sample_depth(que["depth_range"], rn,
                                 self.cfg["depth_sample_num"])
        coarse = self.render_pass(depth, que, ref, img_feats, ray_feats,
                                  False)
        fine_depth = ops.sample_fine_depth(
            depth, coarse["hit"].detach(), que["depth_range"],
            self.cfg["fine_depth_sample_num"], generator)
        fine_depth = torch.sort(fine_depth, -1).values
        fine = self.render_pass(fine_depth, que, ref, img_feats, ray_feats,
                                True)
        return coarse, fine

    def volume(self, ref, img_feats, ray_feats):
        """SDF on the res^3 grid [res,res,res], columns along z sampled
        top-down."""
        res = self.cfg["volume_resolution"]
        bbox = ref["bbox3d_min"]
        pts = ops.grid_points(res, self.cfg["volume_size"], bbox.device) + bbox
        pts = torch.flip(pts.reshape(1, res * res, res, 3), [2])
        prj = self.project(ref, pts, img_feats, ray_feats)
        prj = self.probabilities(self.dist_decoder, prj, ref["depth_range"],
                                 None)
        que_dir = pts.new_tensor([0.0, 0.0, 1.0]).expand_as(pts)
        sdf = self.agg_net.sdf(prj, que_dir, pts)
        return torch.flip(sdf.reshape(res, res, res), [2])

    def depth_means(self, ref, ray_feats, generator):
        """The mixture means at n random pixels of every view (one
        permutation drawn from `generator`, on its own device)."""
        V, h, w, _ = ref["imgs"].shape
        n = min(self.cfg["depth_loss_coords_num"], h * w)
        idx = torch.randperm(h * w, generator=generator,
                             device=generator.device)[:n].to(ray_feats.device)
        coords = torch.stack([(idx % w).float(), (idx // w).float()], -1)
        coords = coords[None].expand(V, n, 2)
        feats = ops.fetch_masked(ray_feats, coords, coords.new_ones((V, n)),
                                 h, w)
        return (coords, self.dist_decoder.mean(feats)[..., 0],
                self.fine_dist_decoder.mean(feats)[..., 0])


class VGN(nn.Module):
    def __init__(self):
        super().__init__()
        enc = [(1, 16, 5, 2), (16, 32, 3, 2), (32, 64, 3, 2)]
        dec = [(64, 64, 3, 1), (64, 32, 3, 1), (32, 16, 5, 1)]
        self.encoder = nn.Module()
        self.decoder = nn.Module()
        for part, dims in ((self.encoder, enc), (self.decoder, dec)):
            for i, (ci, co, k, s) in enumerate(dims):
                setattr(part, f"conv{i + 1}", Conv3d(ci, co, k, s, k // 2))
        self.conv_qual = Conv3d(16, 1, 5, 1, 2)
        self.conv_rot = Conv3d(16, 4, 5, 1, 2)
        self.conv_width = Conv3d(16, 1, 5, 1, 2)

    def forward(self, vol):
        """vol [res,res,res] -> (qual, rot, width, the rotation's norm before
        it is normalised), each [res,res,res,C]."""
        res = vol.shape[0]
        e, d = self.encoder, self.decoder
        x = vol[None, None]
        x = F.relu(e.conv3(F.relu(e.conv2(F.relu(e.conv1(x))))))
        x = ops.resize_nearest_3d(F.relu(d.conv1(x)), res // 4)
        x = ops.resize_nearest_3d(F.relu(d.conv2(x)), res // 2)
        x = ops.resize_nearest_3d(F.relu(d.conv3(x)), res)
        qual = torch.sigmoid(self.conv_qual(x))
        rot = self.conv_rot(x)
        norm = torch.linalg.norm(rot, dim=1, keepdim=True)
        rot = rot / norm.clamp_min(1e-12)
        width = self.conv_width(x)
        return tuple(t[0].permute(1, 2, 3, 0)
                     for t in (qual, rot, width, norm))


class GraspNeRF(nn.Module):
    """Keys `nr_net.*` and `vgn_net.*`, as the port's state dict."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.nr_net = Renderer(cfg)
        self.vgn_net = VGN()

    def plan(self, ref):
        """The planning call's device part: (tsdf [res]^3, (qual, rot,
        width, rotation norm))."""
        img_feats, ray_feats = self.nr_net.encode(ref["imgs"])
        vol = self.nr_net.volume(ref, img_feats, ray_feats)
        return vol, self.vgn_net(vol)

    def train_forward(self, data, generator):
        """The training forward: the two render passes with the fine
        quantiles drawn from `generator`, the volume, the grasp head at the
        labelled voxels, then the depth-loss pixels from `generator`."""
        ref, que = data["ref"], data["que"]
        nr = self.nr_net
        img_feats, ray_feats = nr.encode(ref["imgs"])
        coarse, fine = nr.render(que, ref, img_feats, ray_feats, generator)
        vol = nr.volume(ref, img_feats, ray_feats)
        qual, rot, width, _ = self.vgn_net(vol)
        i, j, k = data["grasp_index"].unbind(-1)
        coords, mean, mean_fine = nr.depth_means(ref, ray_feats, generator)
        return {"coarse": coarse, "fine": fine, "volume": vol,
                "grasp": (qual[i, j, k, 0], rot[i, j, k], width[i, j, k, 0]),
                "depth_coords": coords, "depth_mean": mean,
                "depth_mean_fine": mean_fine}


def build(cfg: dict, state_dict, device, precision: Optional[Precision] = None
          ) -> GraspNeRF:
    """The reference model with `state_dict` (the port's keys, strict) on
    `device`, its products in `precision` (float32 by default)."""
    model = GraspNeRF(cfg)
    model.load_state_dict({k: v.detach().float() for k, v in
                           state_dict.items()}, strict=True)
    return set_precision(model.to(device), precision or Precision("float32"))
