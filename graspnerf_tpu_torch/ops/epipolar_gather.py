"""Epipolar feature gather: for every (view, point), bilinear samples of the
full-res RGB (align_corners=True) and of the two quarter-res feature maps
(align_corners=False), border-clamped and times the validity mask.

Replaces `pack_feature_maps` + `fused_epipolar_gather`
(graspnerf_tpu/ops/fused_gather.py:43-64,232-252). The space-to-depth packing
and windowed gathers there are TPU workarounds; the CUDA kernel
(csrc/epipolar_gather.cu) reads the four taps of each map straight from the
channels-last maps; `launcher` also takes preallocated outputs.

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


_lib = None
_I32 = 2 ** 31 - 1


def library() -> ctypes.CDLL:
    """The kernel's library, its entry points typed at first load."""
    global _lib
    if _lib is None:
        lib = build.load("epipolar_gather")
        lib.epipolar_gather_forward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.epipolar_gather_forward.restype = ctypes.c_int
        lib.epipolar_gather_points_per_block.argtypes = []
        lib.epipolar_gather_points_per_block.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out):
    """Raise on what the kernel does not take."""
    V, H, W, c3 = imgs.shape
    Vf, fh, fw, C = img_feats.shape
    P = xy.shape[1] if xy.dim() == 3 else -1
    if (c3, Vf) != (3, V) or (
            ray_feats.shape, xy.shape, valid.shape, rgb_out.shape,
            ray_out.shape) != ((V, fh, fw, C), (V, P, 2), (V, P),
                               (V, P, 3 + C), (V, P, C)):
        raise ValueError(
            "shapes do not match imgs [V,H,W,3], maps [V,fh,fw,C], xy "
            "[V,P,2], valid [V,P], outputs [V,P,3+C], [V,P,C]: " + ", ".join(
                str(tuple(t.shape)) for t in (imgs, img_feats, ray_feats, xy,
                                              valid, rgb_out, ray_out)))
    if (fh, fw) == (H, W) or not 0 < C <= 32:
        raise ValueError("kernel needs quarter-res maps of at most 32 channels")
    # the kernel indexes inside one view in 32 bits; views go on grid.y
    if max(P * (3 + C), H * W * 3, fh * fw * C) > _I32 or V > 65535:
        raise ValueError("a view's tensors exceed 32-bit indexing, or more "
                         "than 65,535 views")
    floats = (imgs, img_feats, ray_feats, xy, rgb_out, ray_out)
    if valid.dtype != torch.bool or any(t.dtype != torch.float32
                                        for t in floats):
        raise TypeError("kernel takes float32 tensors and a bool valid")
    device = imgs.device
    for t in (*floats, valid):
        if not t.is_contiguous() or t.device != device:
            raise ValueError("kernel takes contiguous tensors on one device")


def launcher(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out):
    """Check the CUDA tensors once and return a call that launches the kernel
    on them, writing rgb_out [V,P,3+C] and ray_out [V,P,C]: the wrapper's
    launch, and the bare launch that chip_smoke.py and
    tools/gather_variants.py time. Each call counts one launch."""
    _check(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out)
    tensors = (imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out)
    V, H, W, _ = imgs.shape
    _, fh, fw, C = img_feats.shape
    args = [t.data_ptr() for t in tensors] + [V, xy.shape[1], H, W, fh, fw, C]
    fn = library().epipolar_gather_forward
    device = xy.device

    def launch():
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream().cuda_stream)
        build.check(status, "epipolar_gather")
        epipolar_gather.launches += 1
        return tensors[5], tensors[6]   # the closure keeps all seven alive

    return launch


def _launch(imgs, img_feats, ray_feats, xy, valid):
    V, P = xy.shape[:2]
    C = img_feats.shape[3]
    rgb_out = torch.empty((V, P, 3 + C), dtype=torch.float32, device=xy.device)
    ray_out = torch.empty((V, P, C), dtype=torch.float32, device=xy.device)
    return launcher(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out)()


def epipolar_gather(imgs, img_feats, ray_feats, xy, valid):
    """Gather wrapper: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. Same arguments and results as `epipolar_gather_plain`."""
    if imgs.device.type == "cpu":
        return epipolar_gather_plain(imgs, img_feats, ray_feats, xy, valid)
    if imgs.device.type != "cuda":
        raise ValueError(f"no gather for device {imgs.device}")
    return _launch(imgs, img_feats, ray_feats, xy, valid)


epipolar_gather.launches = 0
