"""2D CNN blocks of the view encoders (graspnerf_tpu/models/nn_blocks.py).

Reflect padding on every 3x3/7x7 conv, InstanceNorm (per sample and channel
over H,W, affine, stats in float32), ReLU ResNet blocks in the encoder, ELU
conv blocks in the decoder, bilinear x2 upsampling with align_corners=True.
`dtype` is the compute dtype, as in the JAX modules: every conv computes in
it (models/layers.py), InstanceNorm takes its statistics in float32 and
returns it, the upsampling interpolates in float32.
Inside, the blocks run channels-first ([B,C,H,W], PyTorch's conv layout); the
three encoders (ResUNetLight, RayFeatInitNet, VisEncoder) take and return
channels-last [B,H,W,C] like the JAX modules. Submodule names reproduce the
reference's state-dict keys (e.g. "layer1.0.conv1").
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interpolate import resize_bilinear_align_corners
from .layers import Conv2d

F32 = torch.float32


def torch_conv(cin: int, cout: int, kernel: int, stride: int = 1,
               padding: int | None = None, bias: bool = True,
               pad_mode: str = "reflect", dtype=F32) -> Conv2d:
    """Conv2d with torch-style explicit padding ((k-1)//2 by default)."""
    p = (kernel - 1) // 2 if padding is None else padding
    return Conv2d(cin, cout, kernel, stride, p, bias=bias,
                  padding_mode="reflect" if pad_mode == "reflect" else "zeros",
                  dtype=dtype)


def _conv3x3(cin, cout, stride=1, dtype=F32):
    return torch_conv(cin, cout, 3, stride, bias=False, dtype=dtype)


def _conv1x1(cin, cout, stride=1, bias=False, dtype=F32):
    return torch_conv(cin, cout, 1, stride, bias=bias, dtype=dtype)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True, track_running_stats=False) on [B,C,H,W].
    In another dtype than float32, as JAX does (nn_blocks.py:60-77): the
    normalised values from float32 statistics, rounded to it, then the
    affine in it."""

    def __init__(self, c: int, eps: float = 1e-5, dtype=F32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        if self.dtype == F32:
            return F.instance_norm(x, weight=self.weight, bias=self.bias,
                                   eps=self.eps)
        d = self.dtype
        y = F.instance_norm(x.float(), eps=self.eps).to(d)
        return (y * self.weight.to(d)[:, None, None]
                + self.bias.to(d)[:, None, None])


class BasicBlock(nn.Module):
    """ResNet BasicBlock with InstanceNorm."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, dtype=F32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv3x3(cin, planes, stride, dtype)
        self.bn1 = InstanceNorm(planes, dtype=dtype)
        self.conv2 = _conv3x3(planes, planes, dtype=dtype)
        self.bn2 = InstanceNorm(planes, dtype=dtype)
        self.downsample = (nn.Sequential(_conv1x1(cin, planes, stride,
                                                  dtype=dtype),
                                         InstanceNorm(planes, dtype=dtype))
                           if has_downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = (x.to(self.dtype) if self.downsample is None
                    else self.downsample(x))
        return F.relu(out + identity)


class ResidualBlock(nn.Module):
    """Pre-norm residual block; a 1x1 shortcut only when widths differ."""

    def __init__(self, cin: int, dim_out: int, dtype=F32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Sequential(InstanceNorm(cin, dtype=dtype), nn.ReLU(),
                                  _conv3x3(cin, dim_out, dtype=dtype),
                                  InstanceNorm(dim_out, dtype=dtype),
                                  nn.ReLU(),
                                  _conv3x3(dim_out, dim_out, dtype=dtype))
        self.short_cut = (torch_conv(cin, dim_out, 1, dtype=dtype)
                          if cin != dim_out else None)

    def forward(self, x):
        h = self.conv(x)
        return (x.to(self.dtype) if self.short_cut is None
                else self.short_cut(x)) + h


class ConvINElu(nn.Module):
    """conv + InstanceNorm + ELU."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 dtype=F32):
        super().__init__()
        self.conv = torch_conv(cin, features, kernel, stride, dtype=dtype)
        self.bn = InstanceNorm(features, dtype=dtype)

    def forward(self, x):
        return F.elu(self.bn(self.conv(x)))


class UpConv(nn.Module):
    """x2 bilinear (align_corners) upsample, in float32 as JAX's
    interpolation matrices promote it, + ConvINElu."""

    def __init__(self, cin: int, features: int, kernel: int = 3, dtype=F32):
        super().__init__()
        self.conv = ConvINElu(cin, features, kernel, dtype=dtype)

    def forward(self, x):
        h, w = x.shape[-2:]
        return self.conv(resize_bilinear_align_corners(x.float(), 2 * h,
                                                       2 * w))


class ResUNetLight(nn.Module):
    """2D ResUNet image encoder: [B,H,W,in_dim] (H,W % 8 == 0) ->
    [B,H/4,W/4,out_dim]. Stage widths are 32/64/128 whatever `inplanes` is,
    and layers[3] is never used (as in the reference)."""

    def __init__(self, in_dim: int = 3, layers: Sequence[int] = (2, 3, 6, 3),
                 out_dim: int = 32, inplanes: int = 32, dtype=F32):
        super().__init__()
        d = dict(dtype=dtype)
        self.conv1 = torch_conv(in_dim, inplanes, 7, 2, padding=3, bias=False,
                                **d)
        self.bn1 = InstanceNorm(inplanes, **d)
        self.layer1 = self._stage(inplanes, 32, layers[0], 2, dtype)
        self.layer2 = self._stage(32, 64, layers[1], 2, dtype)
        self.layer3 = self._stage(64, 128, layers[2], 2, dtype)
        self.upconv3 = UpConv(128, 64, **d)
        self.iconv3 = ConvINElu(128, 64, 3, **d)
        self.upconv2 = UpConv(64, 32, **d)
        self.iconv2 = ConvINElu(64, 32, 3, **d)
        self.out_conv = torch_conv(32, out_dim, 1, pad_mode="zeros", **d)

    @staticmethod
    def _stage(cin, planes, blocks, stride, dtype):
        return nn.Sequential(
            BasicBlock(cin, planes, stride, has_downsample=True, dtype=dtype),
            *[BasicBlock(planes, planes, dtype=dtype)
              for _ in range(1, blocks)])

    def forward_nchw(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        # skip connections concatenate [upsampled, encoder skip]
        y = self.iconv3(torch.cat([self.upconv3(x3), x2], 1))
        y = self.iconv2(torch.cat([self.upconv2(y), x1], 1))
        return self.out_conv(y)

    def forward(self, x):
        return self.forward_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class RayFeatInitNet(nn.Module):
    """Per-view ray-feature extractor: a second ResUNet + conv head."""

    def __init__(self, dtype=F32):
        super().__init__()
        self.res_net = ResUNetLight(3, (2, 3, 6, 3), 32, 32, dtype)
        self.out_conv = nn.Sequential(_conv3x3(32, 32, dtype=dtype),
                                      ResidualBlock(32, 32, dtype),
                                      _conv1x1(32, 32, dtype=dtype))

    def forward(self, imgs):
        h = self.res_net.forward_nchw(imgs.permute(0, 3, 1, 2))
        return self.out_conv(h).permute(0, 2, 3, 1)


class VisEncoder(nn.Module):
    """Refines ray feats with image feats; input order concat(img, ray)."""

    def __init__(self, dtype=F32):
        super().__init__()
        self.out_conv = nn.Sequential(_conv3x3(64, 32, dtype=dtype),
                                      ResidualBlock(32, 32, dtype),
                                      ResidualBlock(32, 32, dtype),
                                      _conv1x1(32, 32, dtype=dtype))

    def forward(self, ray_feats, img_feats):
        x = torch.cat([img_feats, ray_feats], -1).permute(0, 3, 1, 2)
        return self.out_conv(x).permute(0, 2, 3, 1)
