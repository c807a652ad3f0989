"""Epipolar feature gather: for every (view, point), bilinear samples of the
full-res RGB (align_corners=True) and of the two quarter-res feature maps
(align_corners=False), border-clamped and times the validity mask.

Replaces `pack_feature_maps` + `fused_epipolar_gather`
(graspnerf_tpu/ops/fused_gather.py:43-64,232-252). The space-to-depth packing
and windowed gathers there are TPU workarounds; the CUDA kernel
(csrc/epipolar_gather.cu) reads the four taps of each map straight from the
channels-last maps.

Output layout: the kernel writes `rgb_feats [V,P,3+C]` (rgb | img_feats),
the concatenation the aggregator feeds to the view fuse
(graspnerf_tpu/models/aggregator.py:105), and `ray_feats [V,P,C]`.
Forward only: the backward kernel arrives with training.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .interpolate import interpolate_feature_map


def epipolar_gather_plain(imgs, img_feats, ray_feats, xy, valid):
    """Plain PyTorch version: three border-clamped bilinear fetches.
    imgs [V,H,W,3], img_feats/ray_feats [V,H/4,W/4,C], xy [V,P,2] full-res
    pixel coords, valid [V,P] -> (rgb_feats [V,P,3+C], ray_feats [V,P,C])."""
    h, w = imgs.shape[1], imgs.shape[2]
    rgb = interpolate_feature_map(imgs, xy, valid, h, w)
    img_f = interpolate_feature_map(img_feats, xy, valid, h, w)
    ray_f = interpolate_feature_map(ray_feats, xy, valid, h, w)
    return torch.cat([rgb, img_f], -1), ray_f


def _check(imgs, img_feats, ray_feats, xy, valid):
    V, H, W, c3 = imgs.shape
    Vf, fh, fw, C = img_feats.shape
    if c3 != 3 or Vf != V or ray_feats.shape != img_feats.shape:
        raise ValueError(f"maps {tuple(imgs.shape)} {tuple(img_feats.shape)} "
                         f"{tuple(ray_feats.shape)} do not match")
    if (fh, fw) == (H, W) or not 0 < C <= 32:
        raise ValueError("kernel needs quarter-res maps of at most 32 channels")
    if xy.dim() != 3 or xy.shape[0] != V or xy.shape[2] != 2:
        raise ValueError(f"xy {tuple(xy.shape)} is not [V,P,2]")
    if valid.shape != xy.shape[:2] or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool {tuple(xy.shape[:2])}")
    for t in (imgs, img_feats, ray_feats, xy):
        if t.dtype != torch.float32:
            raise TypeError(f"kernel takes float32, got {t.dtype}")
    for t in (imgs, img_feats, ray_feats, xy, valid):
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")
        if t.device != imgs.device:
            raise ValueError("all tensors must lie on one device")


def _launch(imgs, img_feats, ray_feats, xy, valid):
    _check(imgs, img_feats, ray_feats, xy, valid)
    V, H, W, _ = imgs.shape
    _, fh, fw, C = img_feats.shape
    P = xy.shape[1]
    rgb_out = torch.empty((V, P, 3 + C), dtype=torch.float32, device=xy.device)
    ray_out = torch.empty((V, P, C), dtype=torch.float32, device=xy.device)
    lib = build.load("epipolar_gather")
    fn = lib.epipolar_gather_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(xy.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(imgs.data_ptr(), img_feats.data_ptr(),
                    ray_feats.data_ptr(), xy.data_ptr(), valid.data_ptr(),
                    rgb_out.data_ptr(), ray_out.data_ptr(),
                    V, P, H, W, fh, fw, C, stream)
    build.check(status, "epipolar_gather")
    epipolar_gather.launches += 1
    return rgb_out, ray_out


def epipolar_gather(imgs, img_feats, ray_feats, xy, valid):
    """Gather wrapper: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. Same arguments and results as `epipolar_gather_plain`."""
    if imgs.device.type == "cpu":
        return epipolar_gather_plain(imgs, img_feats, ray_feats, xy, valid)
    if imgs.device.type != "cuda":
        raise ValueError(f"no gather for device {imgs.device}")
    return _launch(imgs, img_feats, ray_feats, xy, valid)


epipolar_gather.launches = 0
