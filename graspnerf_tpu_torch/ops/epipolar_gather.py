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

Gradients: on CUDA tensors the wrapper is an autograd Function whose
backward launches the kernel's transpose (`epipolar_gather_backward`, the
port of `_feg_bwd`, fused_gather.py:260-270): the maps' gradients, and the
RGB image's only when `imgs` requires one. The gradient with respect to `xy`
is not ported (ROADMAP Queue 2): no path needs it, and the wrapper raises if
xy requires one. On CPU tensors autograd differentiates the plain version,
which is also the backward's plain version
(`epipolar_gather_backward_plain`).
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
        lib.epipolar_gather_backward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.epipolar_gather_backward.restype = ctypes.c_int
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


def backward_launcher(d_imgs, d_img_feats, d_ray_feats, xy, valid, d_rgb,
                      d_ray, write_imgs: bool = True):
    """Check the CUDA tensors once (as `_check` does the forward's: the
    gradients have the shapes of the maps and outputs they belong to) and
    return a call that launches the backward kernel, adding into d_imgs
    [V,H,W,3] (only if write_imgs), d_img_feats and d_ray_feats
    [V,fh,fw,C]. Each call counts one launch of `epipolar_gather_backward`."""
    _check(d_imgs, d_img_feats, d_ray_feats, xy, valid, d_rgb, d_ray)
    V, H, W, _ = d_imgs.shape
    _, fh, fw, C = d_img_feats.shape
    args = ([xy.data_ptr(), valid.data_ptr(), d_rgb.data_ptr(),
             d_ray.data_ptr(), d_imgs.data_ptr() if write_imgs else None,
             d_img_feats.data_ptr(), d_ray_feats.data_ptr()]
            + [V, xy.shape[1], H, W, fh, fw, C])
    fn = library().epipolar_gather_backward
    device = xy.device
    keep = (d_imgs, d_img_feats, d_ray_feats, xy, valid, d_rgb, d_ray)

    def launch():
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream().cuda_stream)
        build.check(status, "epipolar_gather_backward")
        epipolar_gather_backward.launches += 1
        return keep[:3]   # the closure keeps all seven alive

    return launch


def epipolar_gather_backward_plain(imgs_shape, maps_shape, xy, valid, d_rgb,
                                   d_ray, need_imgs: bool = False):
    """Plain version of the backward: autograd through
    `epipolar_gather_plain` (the bilinear weights do not depend on the maps'
    values, so zero maps of the given shapes stand in for them). -> (d_imgs
    [V,H,W,3] or None, d_img_feats, d_ray_feats [V,fh,fw,C])."""
    with torch.enable_grad():
        f = dict(dtype=torch.float32, device=xy.device, requires_grad=True)
        maps = [torch.zeros(imgs_shape, **f), torch.zeros(maps_shape, **f),
                torch.zeros(maps_shape, **f)]
        outs = epipolar_gather_plain(*maps, xy.detach(), valid)
        grads = torch.autograd.grad(outs, maps, (d_rgb, d_ray))
    return (grads[0] if need_imgs else None, grads[1], grads[2])


def epipolar_gather_backward(xy, valid, d_rgb, d_ray, imgs_shape, maps_shape,
                             need_imgs: bool = False):
    """Backward wrapper: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors. d_rgb [V,P,3+C] and d_ray [V,P,C] are the gradients of
    the gather's two outputs -> (d_imgs [V,H,W,3], or None unless
    need_imgs, d_img_feats, d_ray_feats [V,fh,fw,C])."""
    if xy.device.type == "cpu":
        return epipolar_gather_backward_plain(imgs_shape, maps_shape, xy,
                                              valid, d_rgb, d_ray, need_imgs)
    if xy.device.type != "cuda":
        raise ValueError(f"no gather backward for device {xy.device}")
    f = dict(dtype=torch.float32, device=xy.device)
    # d_imgs only when asked for; otherwise an unwritten stand-in that
    # gives the kernel its H and W
    d_imgs = (torch.zeros if need_imgs else torch.empty)(imgs_shape, **f)
    d_img_feats = torch.zeros(maps_shape, **f)
    d_ray_feats = torch.zeros(maps_shape, **f)
    backward_launcher(d_imgs, d_img_feats, d_ray_feats, xy, valid,
                      d_rgb.contiguous(), d_ray.contiguous(), need_imgs)()
    return (d_imgs if need_imgs else None, d_img_feats, d_ray_feats)


class _GatherFn(torch.autograd.Function):
    """Kernel forward; backward = the backward kernel (maps, and the image
    when it requires a gradient); xy and valid get none."""

    @staticmethod
    def forward(ctx, imgs, img_feats, ray_feats, xy, valid):
        ctx.save_for_backward(xy, valid)
        ctx.shapes = (imgs.shape, img_feats.shape)
        return _launch(imgs, img_feats, ray_feats, xy, valid)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_rgb, d_ray):
        xy, valid = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_imgs, d_img_feats, d_ray_feats = epipolar_gather_backward(
            xy, valid, d_rgb, d_ray, *ctx.shapes, need[0])
        return (d_imgs, d_img_feats if need[1] else None,
                d_ray_feats if need[2] else None, None, None)


def epipolar_gather(imgs, img_feats, ray_feats, xy, valid):
    """Gather wrapper: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. Same arguments and results as `epipolar_gather_plain`;
    differentiable with respect to the three maps."""
    if imgs.device.type == "cpu":
        return epipolar_gather_plain(imgs, img_feats, ray_feats, xy, valid)
    if imgs.device.type != "cuda":
        raise ValueError(f"no gather for device {imgs.device}")
    if xy.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the gather's gradient with respect to xy is not ported: "
            "ROADMAP Queue 2")
    return _GatherFn.apply(imgs, img_feats, ray_feats, xy, valid)


epipolar_gather.launches = 0
epipolar_gather_backward.launches = 0
