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

Fused norms (`fused_norms`): on a CUDA tensor, with autograd off, in
float32 and with the renderer's `use_kernels`, the encoders run each
InstanceNorm with what surrounds it as one launch of
ops/instance_norm.py's kernel: the norm, the residual add before the
activation (BasicBlock), the activation, and the store already
reflect-padded for the next convolution, which then runs `F.conv2d` with
no padding on it: the call `Conv2d`'s reflect mode makes after its own
`F.pad`, on the same shape. ResidualBlock's output sum goes into the next
block's first norm (`add`), which writes it once for the next shortcut;
an UpConv writes its padded output into the decoder's padded
concatenation, whose other half is the padded skip; the two norms before
an UpConv write their output upsampled (bilinear x2, align_corners) and
reflect-padded for its convolution. The 7x7 pads of the images stay as
they are. Every other call (training, bfloat16, the CPU, `use_kernels`
False) runs the modules' own chain. The kernel holds a plane in one
block's shared memory: the first norm's plane, half the image each way,
fits up to 57,856 floats (360 x 640 images fit, 480 x 640 do not); on
larger images the fused path raises.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.instance_norm import instance_norm_act
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


def fused_norms(module: nn.Module, x: torch.Tensor) -> bool:
    """Whether encoder `module` runs its norms fused on input x: x on a
    CUDA device, autograd off, module and x in float32, the module's
    `use_kernels`. Planes the kernel cannot take then raise from it."""
    return (module.use_kernels and x.device.type == "cuda"
            and x.dtype == F32 and module.dtype == F32
            and not torch.is_grad_enabled())


def _norm(x, norm: InstanceNorm, act=None, **kw):
    """`norm` on x fused with act and kw (ops/instance_norm.py)."""
    return instance_norm_act(x, norm.weight, norm.bias, act, eps=norm.eps,
                             **kw)


def _conv(conv: Conv2d, x):
    """A reflect-mode `conv` on x already padded as it pads (its plain
    input for a 1x1)."""
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, 0, conv.dilation,
                    conv.groups)


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

    def fused(self, x, xp, up: bool = False):
        """forward with fused norms: x and xp, x reflect-padded by 1 ->
        (y, y reflect-padded by 1); with `up` (None, y upsampled x2 and
        reflect-padded by 1, an UpConv's input)."""
        h = _norm(_conv(self.conv1, xp), self.bn1, "relu", pad=1,
                  unpadded=False).padded
        h = _conv(self.conv2, h)
        identity = (x if self.downsample is None else
                    _norm(_conv(self.downsample[0], x), self.downsample[1]).out)
        r = _norm(h, self.bn2, "relu", residual=identity, pad=1, up=up,
                  unpadded=not up)
        return r.out, r.padded


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

    def fused(self, x, add=None):
        """forward with fused norms on x + add (add: the previous block's
        shortcut, None for none) -> (shortcut, h), the block's output
        shortcut + h left to its reader."""
        r = _norm(x, self.conv[0], "relu", add=add, pad=1, unpadded=False)
        x = x if add is None else r.sum
        h = _norm(_conv(self.conv[2], r.padded), self.conv[3], "relu", pad=1,
                  unpadded=False).padded
        h = _conv(self.conv[5], h)
        return (x if self.short_cut is None else _conv(self.short_cut, x)), h


class ConvINElu(nn.Module):
    """conv + InstanceNorm + ELU."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 dtype=F32):
        super().__init__()
        self.conv = torch_conv(cin, features, kernel, stride, dtype=dtype)
        self.bn = InstanceNorm(features, dtype=dtype)

    def forward(self, x):
        return F.elu(self.bn(self.conv(x)))

    def fused(self, xp, up: bool = False):
        """forward with the fused norm on xp, x reflect-padded as the
        convolution pads it; with `up` the output upsampled x2 and
        reflect-padded by 1 (an UpConv's input)."""
        r = _norm(_conv(self.conv, xp), self.bn, "elu", pad=int(up), up=up,
                  unpadded=not up)
        return r.padded if up else r.out


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

    def fused(self, xp, skip):
        """forward with the fused norm on xp, x already upsampled and
        reflect-padded by 1 (by the norm before): its output reflect-padded
        by 1 and followed by skip (reflect-padded by 1), the padded
        concatenation [out, skip] that the decoder's next convolution
        reads."""
        c = _conv(self.conv.conv, xp)
        b, ch, hc, wc = c.shape
        buf = c.new_empty(b, ch + skip.shape[1], hc + 2, wc + 2)
        _norm(c, self.conv.bn, "elu", pad=1, unpadded=False,
              padded=buf[:, :ch])
        buf[:, ch:].copy_(skip)
        return buf


class ResUNetLight(nn.Module):
    """2D ResUNet image encoder: [B,H,W,in_dim] (H,W % 8 == 0) ->
    [B,H/4,W/4,out_dim]. Stage widths are 32/64/128 whatever `inplanes` is,
    and layers[3] is never used (as in the reference)."""

    def __init__(self, in_dim: int = 3, layers: Sequence[int] = (2, 3, 6, 3),
                 out_dim: int = 32, inplanes: int = 32, dtype=F32,
                 use_kernels: bool = True):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
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
        if fused_norms(self, x):
            return self._forward_fused(x)
        x = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        # skip connections concatenate [upsampled, encoder skip]
        y = self.iconv3(torch.cat([self.upconv3(x3), x2], 1))
        y = self.iconv2(torch.cat([self.upconv2(y), x1], 1))
        return self.out_conv(y)

    def _forward_fused(self, x):
        """forward_nchw with fused norms (`fused_norms`): each stage's output
        also reflect-padded for the next stage's first convolution (and
        kept as the decoder's padded skip); the last stage's, and iconv3's,
        upsampled and reflect-padded for the UpConv after it."""
        r = _norm(self.conv1(x), self.bn1, "relu", pad=1)
        y, yp = r.out, r.padded
        skips = []
        for stage in (self.layer1, self.layer2, self.layer3):
            for i, block in enumerate(stage):
                up = stage is self.layer3 and i == len(stage) - 1
                y, yp = block.fused(y, yp, up=up)
            skips.append(yp)
        y = self.iconv3.fused(self.upconv3.fused(skips[2], skips[1]), up=True)
        y = self.iconv2.fused(self.upconv2.fused(y, skips[0]))
        return self.out_conv(y)

    def forward(self, x):
        return self.forward_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _out_conv_fused(seq: nn.Sequential, x):
    """seq (a 3x3 convolution, ResidualBlocks, a 1x1 convolution) on x
    with fused norms: each block's output sum goes into the next block's
    first norm."""
    s, h = None, seq[0](x)
    for block in seq[1:-1]:
        s, h = block.fused(h, add=s)
    return _conv(seq[-1], h if s is None else s + h)


class RayFeatInitNet(nn.Module):
    """Per-view ray-feature extractor: a second ResUNet + conv head."""

    def __init__(self, dtype=F32, use_kernels: bool = True):
        super().__init__()
        self.res_net = ResUNetLight(3, (2, 3, 6, 3), 32, 32, dtype,
                                    use_kernels)
        self.out_conv = nn.Sequential(_conv3x3(32, 32, dtype=dtype),
                                      ResidualBlock(32, 32, dtype),
                                      _conv1x1(32, 32, dtype=dtype))

    def forward(self, imgs):
        x = imgs.permute(0, 3, 1, 2)
        if fused_norms(self.res_net, x):
            out = _out_conv_fused(self.out_conv, self.res_net._forward_fused(x))
        else:
            out = self.out_conv(self.res_net.forward_nchw(x))
        return out.permute(0, 2, 3, 1)


class VisEncoder(nn.Module):
    """Refines ray feats with image feats; input order concat(img, ray)."""

    def __init__(self, dtype=F32, use_kernels: bool = True):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.out_conv = nn.Sequential(_conv3x3(64, 32, dtype=dtype),
                                      ResidualBlock(32, 32, dtype),
                                      ResidualBlock(32, 32, dtype),
                                      _conv1x1(32, 32, dtype=dtype))

    def forward(self, ray_feats, img_feats):
        x = torch.cat([img_feats, ray_feats], -1).permute(0, 3, 1, 2)
        if fused_norms(self, x):
            out = _out_conv_fused(self.out_conv, x)
        else:
            out = self.out_conv(x)
        return out.permute(0, 2, 3, 1)
