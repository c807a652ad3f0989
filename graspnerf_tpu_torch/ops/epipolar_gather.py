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
RGB image's only when `imgs` requires one. It pulls rather than scatters:
points are indexed by the map tiles their taps reach, then each map cell
sums its contributions in a fixed order and is written once, so the
gradients are deterministic (csrc/epipolar_gather.cu). The gradient with
respect to `xy` is not ported (ROADMAP Queue 2): no path needs it, and the
wrapper raises if xy requires one. On CPU tensors autograd differentiates the plain version,
which is also the backward's plain version
(`epipolar_gather_backward_plain`).

bfloat16: with the three maps in bfloat16 (`pack_feature_maps(dtype)`,
fused_gather.py:43-64) the kernel's bfloat16 instance reads them, weighs
and blends the taps in float32 as before, and writes both outputs rounded
to bfloat16: every consumer of the gathered features in the JAX package
rounds them to bfloat16 before first use (dist_decoder.py:45,
aggregator.py:95-96, ibrnet.py:212-216). The plain version rounds at the
same place. Its backward is not ported: on the card the wrapper raises
when a bfloat16 map requires a gradient.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .interpolate import interpolate_feature_map

F32, BF16 = torch.float32, torch.bfloat16


def epipolar_gather_plain(imgs, img_feats, ray_feats, xy, valid):
    """Plain PyTorch version: three border-clamped bilinear fetches.
    imgs [V,H,W,3], img_feats/ray_feats [V,H/4,W/4,C] of one dtype, xy
    [V,P,2] full-res pixel coords, valid [V,P] -> (rgb_feats [V,P,3+C],
    ray_feats [V,P,C]) in the maps' dtype, interpolated in float32."""
    h, w = imgs.shape[1], imgs.shape[2]
    rgb = interpolate_feature_map(imgs, xy, valid, h, w)
    img_f = interpolate_feature_map(img_feats, xy, valid, h, w)
    ray_f = interpolate_feature_map(ray_feats, xy, valid, h, w)
    dtype = img_feats.dtype
    return torch.cat([rgb, img_f], -1).to(dtype), ray_f.to(dtype)


_lib = None
_I32 = 2 ** 31 - 1


def library() -> ctypes.CDLL:
    """The kernel's library, its entry points typed at first load."""
    global _lib
    if _lib is None:
        lib = build.load("epipolar_gather")
        for name in ("epipolar_gather_forward", "epipolar_gather_forward_bf16"):
            getattr(lib, name).argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
            getattr(lib, name).restype = ctypes.c_int
        lib.epipolar_gather_backward.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.epipolar_gather_backward.restype = ctypes.c_int
        lib.epipolar_gather_backward_scratch.argtypes = [ctypes.c_int] * 4
        lib.epipolar_gather_backward_scratch.restype = ctypes.c_longlong
        lib.epipolar_gather_backward_info.argtypes = [ctypes.c_void_p]
        lib.epipolar_gather_backward_info.restype = ctypes.c_int
        for name in ("epipolar_gather_points_per_block",
                     "epipolar_gather_backward_launches"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out,
           dtypes=(F32, BF16)):
    """Raise on what the kernel does not take: maps and outputs of one of
    `dtypes`, float32 coordinates, a bool mask."""
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
    maps = (imgs, img_feats, ray_feats, rgb_out, ray_out)
    if (valid.dtype != torch.bool or xy.dtype != F32
            or imgs.dtype not in dtypes
            or any(t.dtype != imgs.dtype for t in maps)):
        raise TypeError(f"kernel takes maps and outputs of one dtype of "
                        f"{dtypes}, float32 xy and a bool valid")
    device = imgs.device
    for t in (*maps, xy, valid):
        if not t.is_contiguous() or t.device != device:
            raise ValueError("kernel takes contiguous tensors on one device")


def launcher(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out):
    """Check the CUDA tensors once and return a call that launches the kernel
    on them (the float32 or the bfloat16 instance, as the maps' dtype says),
    writing rgb_out [V,P,3+C] and ray_out [V,P,C]: the wrapper's launch, and
    the bare launch that chip_smoke.py and tools/gather_variants.py time.
    Each call counts one launch."""
    _check(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out)
    tensors = (imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out)
    V, H, W, _ = imgs.shape
    _, fh, fw, C = img_feats.shape
    args = [t.data_ptr() for t in tensors] + [V, xy.shape[1], H, W, fh, fw, C]
    bf16 = imgs.dtype == BF16
    lib = library()
    fn = lib.epipolar_gather_forward_bf16 if bf16 else lib.epipolar_gather_forward
    device = xy.device

    def launch():
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream().cuda_stream)
        build.check(status, "epipolar_gather")
        epipolar_gather.launches += 1
        epipolar_gather.bf16_launches += bf16
        return tensors[5], tensors[6]   # the closure keeps all seven alive

    return launch


def _launch(imgs, img_feats, ray_feats, xy, valid):
    V, P = xy.shape[:2]
    C = img_feats.shape[3]
    out = dict(dtype=img_feats.dtype, device=xy.device)
    rgb_out = torch.empty((V, P, 3 + C), **out)
    ray_out = torch.empty((V, P, C), **out)
    return launcher(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out)()


def backward_launcher(d_imgs, d_img_feats, d_ray_feats, xy, valid, d_rgb,
                      d_ray, write_imgs: bool = True):
    """Check the CUDA tensors once (as `_check` does the forward's: the
    gradients have the shapes of the maps and outputs they belong to),
    allocate the index's scratch, and return a call that launches the
    backward: it writes every cell of d_img_feats and d_ray_feats
    [V,fh,fw,C] and, only if write_imgs, adds into d_imgs [V,H,W,3]. Each
    call counts one launch of `epipolar_gather_backward` (a memset and three
    kernels on the card, `backward_cuda_launches`)."""
    _check(d_imgs, d_img_feats, d_ray_feats, xy, valid, d_rgb, d_ray, (F32,))
    V, H, W, _ = d_imgs.shape
    _, fh, fw, C = d_img_feats.shape
    P = xy.shape[1]
    lib = library()
    ints = lib.epipolar_gather_backward_scratch(V, P, fh, fw)
    if ints < 0:
        raise ValueError(f"gather backward: a {fh} x {fw} map has more tiles "
                         f"than the index takes")
    scratch = torch.empty(ints, dtype=torch.int32, device=xy.device)
    args = ([xy.data_ptr(), valid.data_ptr(), d_rgb.data_ptr(),
             d_ray.data_ptr(), d_imgs.data_ptr() if write_imgs else None,
             d_img_feats.data_ptr(), d_ray_feats.data_ptr(),
             scratch.data_ptr()] + [V, P, H, W, fh, fw, C])
    fn = lib.epipolar_gather_backward
    device = xy.device
    keep = (d_imgs, d_img_feats, d_ray_feats, xy, valid, d_rgb, d_ray, scratch)

    def launch():
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream().cuda_stream)
        build.check(status, "epipolar_gather_backward")
        epipolar_gather_backward.launches += 1
        return keep[:3]   # the closure keeps all eight alive

    return launch


def backward_cuda_launches() -> int:
    """CUDA launches (memsets included) of one backward call without
    d_imgs, as built."""
    return library().epipolar_gather_backward_launches()


def backward_kernel_info() -> dict:
    """The backward's kernels as built, on the current card: registers,
    spilled (local) bytes and static shared memory a thread block of the
    count, fill and pull kernels; the pull's dynamic shared memory and
    resident blocks per SM."""
    out = (ctypes.c_int * 11)()
    build.check(library().epipolar_gather_backward_info(out),
                "epipolar_gather_backward_info")
    info = {f"{k}_{f}": out[3 * i + j]
            for i, k in enumerate(("count", "fill", "pull"))
            for j, f in enumerate(("registers", "spill_bytes", "static_smem"))}
    info.update(pull_dynamic_smem=out[9], pull_blocks_per_sm=out[10])
    return info


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
    # d_imgs only when asked for (added into); otherwise an unwritten
    # stand-in that gives the kernel its H and W. The kernel writes every
    # cell of the maps' gradients.
    d_imgs = (torch.zeros if need_imgs else torch.empty)(imgs_shape, **f)
    d_img_feats = torch.empty(maps_shape, **f)
    d_ray_feats = torch.empty(maps_shape, **f)
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
    in float32 differentiable with respect to the three maps."""
    if imgs.device.type == "cpu":
        return epipolar_gather_plain(imgs, img_feats, ray_feats, xy, valid)
    if imgs.device.type != "cuda":
        raise ValueError(f"no gather for device {imgs.device}")
    grad = torch.is_grad_enabled()
    if xy.requires_grad and grad:
        raise NotImplementedError(
            "the gather's gradient with respect to xy is not ported: "
            "ROADMAP Queue 2")
    if imgs.dtype == BF16:
        if grad and any(t.requires_grad for t in (imgs, img_feats,
                                                  ray_feats)):
            raise NotImplementedError(
                "the gather's bfloat16 backward (the maps' gradients in "
                "bfloat16) is not ported: ROADMAP Queue 1")
        return _launch(imgs, img_feats, ray_feats, xy, valid)
    return _GatherFn.apply(imgs, img_feats, ray_feats, xy, valid)


# launches of each kernel; of the forward's bfloat16 instance alone
epipolar_gather.launches = 0
epipolar_gather.bf16_launches = 0
epipolar_gather_backward.launches = 0
