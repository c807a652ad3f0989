"""Epipolar aggregation network, IBRNet with NeuRay, NeuS variant
(graspnerf_tpu/models/ibrnet.py:35-243), on [V,N,C] tensors: V views
leading, N = rays*samples.

The per-view MLP stack and the fusion across views go through
ops/view_fuse.py (the CUDA kernel on the card, its plain version on the CPU).
The geometry head and the colour blend are plain PyTorch.

∇sdf, the gradient of the SDF with respect to the query points alone, is
the render path's third output: the JAX module takes it with a `jax.vjp` of
the geometry head that closes over the fused features (ibrnet.py:233-236).
Here autograd differentiates the same head with respect to a separate leaf
copy of the points. With grad enabled (training) the features stay attached
and the gradient keeps its graph (`create_graph`), so the eikonal term
reaches the geometry head and the view fuse through the double backward, as
in JAX; under the callers' `no_grad` it runs in a local `enable_grad` on
detached features. The volume path calls `geometry` and pays nothing for it.

`dtype`, the compute dtype (ibrnet.py:60-248): every Linear computes in it
(models/layers.py), and so do the view fuse (as the Pallas kernel does in
it), the attention and the positional table; LayerNorm takes float32
statistics; the SDF, its clip, ∇sdf's points and the colour blend's
softmax stay float32.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.view_fuse import W_NAMES, view_fuse, view_fuse_plain
from .layers import Linear

F32 = torch.float32


def positional_table(n_samples: int, d_hid: int = 16) -> np.ndarray:
    """Sinusoid table [1, n_samples, d_hid]."""
    pos = np.arange(n_samples)[:, None]
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (j // 2) / d_hid)
    table = np.where(j % 2 == 0, np.sin(angle), np.cos(angle))
    return table[None].astype(np.float32)


def embed_points(pts: torch.Tensor, multires: int = 3) -> torch.Tensor:
    """NeRF positional encoding with the input included:
    [..., 3] -> [..., 3 + 3*2*multires]."""
    out = [pts]
    for i in range(multires):
        freq = 2.0 ** i
        out += [torch.sin(pts * freq), torch.cos(pts * freq)]
    return torch.cat(out, -1)


def _seq(dims, acts, d_in, dtype=F32) -> nn.Sequential:
    """Linear stack named like the reference's Sequential ("0", "2", ...):
    every Linear is followed by its activation module (or an Identity)."""
    layers = []
    for d, a in zip(dims, acts):
        layers += [Linear(d_in, d, dtype=dtype),
                   {"elu": nn.ELU(), "sigmoid": nn.Sigmoid(),
                    None: nn.Identity()}[a]]
        d_in = d
    return nn.Sequential(*layers[:-1] if acts[-1] is None else layers)


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head attention along the sample axis. q/k/v [B,L,16];
    mask [B,L,1] hides *query rows* with -1e9. Computes in `dtype`; the
    LayerNorm's statistics and affine in float32, its result in `dtype`
    (flax LayerNorm(dtype=...))."""

    def __init__(self, n_head: int = 4, d_model: int = 16, d_k: int = 4,
                 d_v: int = 4, dtype=F32):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dtype = dtype
        self.w_qs = Linear(d_model, n_head * d_k, bias=False, dtype=dtype)
        self.w_ks = Linear(d_model, n_head * d_k, bias=False, dtype=dtype)
        self.w_vs = Linear(d_model, n_head * d_v, bias=False, dtype=dtype)
        self.fc = Linear(n_head * d_v, d_model, bias=False, dtype=dtype)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, q, k, v, mask=None):
        B, L, _ = q.shape
        H = self.n_head
        qh = self.w_qs(q).reshape(B, L, H, self.d_k).transpose(1, 2)
        kh = self.w_ks(k).reshape(B, L, H, self.d_k).transpose(1, 2)
        vh = self.w_vs(v).reshape(B, L, H, self.d_v).transpose(1, 2)
        attn = torch.matmul(qh / (self.d_k ** 0.5), kh.transpose(-1, -2))
        if mask is not None:
            attn = attn.masked_fill(mask[:, None, :, :] == 0, -1e9)
        out = torch.matmul(torch.softmax(attn, -1), vh)
        out = out.transpose(1, 2).reshape(B, L, H * self.d_v)
        return self.layer_norm((self.fc(out) + q).float()).to(self.dtype)


class IBRNetNeus(nn.Module):
    """Inputs ([V,N,C], N = R*D points): rgb_feat [V,N,35] (rgb | image
    features), neuray_feat [V,N,32], ray_diff [V,N,4], mask [V,N,1],
    que_pts [Q,R',D,3] with Q*R' = R."""

    def __init__(self, neuray_in_dim: int = 32, in_feat_ch: int = 32,
                 use_kernels: bool = True, dtype=F32):
        super().__init__()
        f = in_feat_ch
        d = self.dtype = dtype
        self.use_kernels = use_kernels
        self.ray_dir_fc = _seq((16, f + 3), ("elu", "elu"), 4, d)
        self.base_fc = _seq((64, 32), ("elu", "elu"),
                            (f + 3) * 5 + neuray_in_dim, d)
        self.vis_fc = _seq((32, 33), ("elu", "elu"), 32, d)
        self.vis_fc2 = _seq((32, 1), ("elu", "sigmoid"), 32, d)
        self.geometry_fc = _seq((64, 16), ("elu", "elu"), 65 + 21, d)
        self.ray_attention = MultiHeadAttention(dtype=d)
        self.rgb_fc = _seq((16, 8, 1), ("elu", "elu", None), 32 + 1 + 4, d)
        self.neuray_fc = _seq((8, 1), ("elu", None), neuray_in_dim, d)
        # two stacked Linears with no activation between
        self.out_geometry_fc = nn.Sequential(Linear(16, 16, dtype=d),
                                             Linear(16, 1, dtype=d))

    def fuse_weights(self):
        """(weight, bias) pairs of the view-fuse Linears in W_NAMES order."""
        mods = dict(self.named_modules())
        return [(mods[n].weight, mods[n].bias) for n in W_NAMES]

    def view_fuse(self, rgb_feat, neuray_feat, ray_diff, mask):
        """-> (feat_const [N,65], num_valid [N,1], x [V,N,32], vis [V,N,1]),
        num_valid float32, the others in `dtype`; the inputs are cast to it
        (as the Linears cast theirs)."""
        fn = view_fuse if self.use_kernels else view_fuse_plain
        ins = (t.to(self.dtype) for t in (rgb_feat, neuray_feat, ray_diff,
                                          mask))
        return fn(*ins, self.fuse_weights(), self.dtype)

    def geometry(self, feat_const, pts, num_valid):
        """SDF [R,D,1], float32, from the fused features and the point
        embedding; feat_const [R,D,65], num_valid [R,D,1], pts [Q,R',D,3]."""
        R, D, _ = feat_const.shape
        d = self.dtype
        pos_enc = torch.from_numpy(positional_table(D)).to(feat_const.device,
                                                           d)
        g = torch.cat([feat_const.to(d),
                       embed_points(pts).reshape(R, D, -1).to(d)], -1)
        g = self.geometry_fc(g) + pos_enc
        g = self.ray_attention(g, g, g, mask=(num_valid > 1).to(g.dtype))
        sdf = torch.clamp(self.out_geometry_fc(g).float(), -1.0, 1.0)
        return torch.where(num_valid < 1, torch.ones_like(sdf), sdf)

    def geometry_and_grad(self, feat_const, pts, num_valid):
        """(sdf [R,D,1], ∇sdf [Q,R',D,3]): `geometry` and the gradient of its
        sum with respect to pts alone (the projection's use of the points is
        not differentiated). With grad enabled both stay attached to the
        weights and the fused features; under `no_grad` both come back
        detached."""
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

    def blend(self, rgb_in, x, vis, ray_diff, mask):
        """Softmax colour blend over views, in float32 -> [N,3]."""
        h = self.rgb_fc(torch.cat([x, vis, ray_diff], -1))
        h = h.masked_fill(mask == 0, -1e9)
        return torch.sum(rgb_in.float() * torch.softmax(h.float(), 0), 0)

    def forward(self, rgb_feat, neuray_feat, ray_diff, mask, que_pts,
                rd: Tuple[int, int]):
        """-> (rgb [R,D,3], sdf [R,D,1], ∇sdf [Q,R',D,3]), float32."""
        R, D = rd
        feat_const, num_valid, x, vis = self.view_fuse(
            rgb_feat, neuray_feat, ray_diff, mask)
        sdf, grad = self.geometry_and_grad(feat_const.reshape(R, D, -1),
                                           que_pts, num_valid.reshape(R, D, 1))
        rgb = self.blend(rgb_feat[..., :3], x, vis, ray_diff, mask)
        return rgb.reshape(R, D, 3), sdf, grad
