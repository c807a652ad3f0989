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
gradients are deterministic (csrc/epipolar_gather.cu). When `xy` requires
a gradient the backward also launches `epipolar_gather_backward_xy`, the
xy cotangent of `_feg_bwd` (fused_gather.py:268): the a.e. derivative of
the three bilinear samples with respect to each point's coordinates,
contracted with the upstream gradients. No path of the system asks for it
(the cameras and samples carry no gradient); `torch.autograd.grad(outputs,
xy)` reaches it. On float32 CPU tensors autograd differentiates the plain
version, which is also the backward's plain version
(`epipolar_gather_backward_plain`, `epipolar_gather_backward_xy_plain`).

bfloat16: with the three maps in bfloat16 (`pack_feature_maps(dtype)`,
fused_gather.py:43-64) the kernel's bfloat16 instance reads them, weighs
and blends the taps in float32 as before. The dtype rule: rgb_feats comes
back in the maps' dtype, ray_feats always in float32. In bfloat16
rgb_feats is rounded to it, as JAX rounds it before both its uses
(ibrnet.py:212), and ray_feats is the float32 blend, as JAX's gather
returns it (fused_gather.py:178-180): its two consumers round it to
bfloat16 before first use (dist_decoder.py:45, aggregator.py:95-96), and
their bfloat16 gradients meet there in float32, which is what the backward
reads. The plain version rounds at the same place. The backward is `_feg_bwd` on bfloat16 maps, in the plain version
(`epipolar_gather_backward_plain(..., dtype=bfloat16)`, the plain path's
own backward) and in the kernel's bfloat16 instance
(`epipolar_gather_backward_bf16`): per point and window cell, the float32
upstream times the cell's folded tap weight, rounded to bfloat16 (the
transpose of the bfloat16 -> float32 promotion); per map cell the sum of
those in float32, rounded to bfloat16 once.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .interpolate import interpolate_feature_map

F32, BF16 = torch.float32, torch.bfloat16


def _plain(imgs, img_feats, ray_feats, xy, valid):
    h, w = imgs.shape[1], imgs.shape[2]
    rgb = interpolate_feature_map(imgs, xy, valid, h, w)
    img_f = interpolate_feature_map(img_feats, xy, valid, h, w)
    ray_f = interpolate_feature_map(ray_feats, xy, valid, h, w)
    return torch.cat([rgb, img_f], -1).to(img_feats.dtype), ray_f.float()


def _needs_grad(*maps) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in maps)


def epipolar_gather_plain(imgs, img_feats, ray_feats, xy, valid):
    """Plain PyTorch version: three border-clamped bilinear fetches.
    imgs [V,H,W,3], img_feats/ray_feats [V,H/4,W/4,C] of one dtype, xy
    [V,P,2] full-res pixel coords, valid [V,P] -> (rgb_feats [V,P,3+C] in
    the maps' dtype, ray_feats [V,P,C] float32), interpolated in float32. In
    float32 autograd differentiates it; bfloat16 maps that require a
    gradient take `_feg_bwd`'s arithmetic (`epipolar_gather_backward_plain`,
    and `epipolar_gather_backward_xy_plain` for xy)."""
    if img_feats.dtype == BF16 and _needs_grad(imgs, img_feats, ray_feats,
                                               xy):
        return _GatherFn.apply(True, imgs, img_feats, ray_feats, xy, valid)
    return _plain(imgs, img_feats, ray_feats, xy, valid)


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
        lib.epipolar_gather_backward_bf16.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.epipolar_gather_backward_bf16.restype = ctypes.c_int
        for name in ("epipolar_gather_backward_xy",
                     "epipolar_gather_backward_xy_bf16"):
            getattr(lib, name).argtypes = (
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
            getattr(lib, name).restype = ctypes.c_int
        lib.epipolar_gather_backward_xy_info.argtypes = [ctypes.c_int,
                                                         ctypes.c_void_p]
        lib.epipolar_gather_backward_xy_info.restype = ctypes.c_int
        lib.epipolar_gather_backward_scratch.argtypes = [ctypes.c_int] * 4
        lib.epipolar_gather_backward_scratch.restype = ctypes.c_longlong
        lib.epipolar_gather_backward_layout.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.epipolar_gather_backward_layout.restype = ctypes.c_int
        for name in ("epipolar_gather_backward_info",
                     "epipolar_gather_backward_bf16_info"):
            getattr(lib, name).argtypes = [ctypes.c_void_p]
            getattr(lib, name).restype = ctypes.c_int
        for name in ("epipolar_gather_points_per_block",
                     "epipolar_gather_backward_launches"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out,
           dtypes=(F32, BF16), imgs_dtype=None):
    """Raise on what the kernel does not take: maps and rgb_out of one of
    `dtypes` (imgs of `imgs_dtype` when given), a float32 ray_out, float32
    coordinates, a bool mask."""
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
    dtype = img_feats.dtype
    if (valid.dtype != torch.bool or xy.dtype != F32 or dtype not in dtypes
            or any(t.dtype != dtype for t in (ray_feats, rgb_out))
            or imgs.dtype != (imgs_dtype or dtype) or ray_out.dtype != F32):
        raise TypeError(f"kernel takes maps and rgb_out of one dtype of "
                        f"{dtypes}, float32 ray_out and xy, a bool valid")
    device = imgs.device
    for t in (*maps, xy, valid):
        if not t.is_contiguous() or t.device != device:
            raise ValueError("kernel takes contiguous tensors on one device")


def launcher(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out):
    """Check the CUDA tensors once and return a call that launches the kernel
    on them (the float32 or the bfloat16 instance, as the maps' dtype says),
    writing rgb_out [V,P,3+C] (the maps' dtype) and ray_out [V,P,C]
    (float32): the wrapper's launch, and
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
    rgb_out = torch.empty((V, P, 3 + C), dtype=img_feats.dtype,
                          device=xy.device)
    ray_out = torch.empty((V, P, C), dtype=F32, device=xy.device)
    return launcher(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out)()


def backward_launcher(d_imgs, d_img_feats, d_ray_feats, xy, valid, d_rgb,
                      d_ray, write_imgs: bool = True):
    """Check the CUDA tensors once (as `_check` does the forward's: the
    gradients have the shapes of the maps and outputs they belong to),
    allocate the index's scratch, and return a call that launches the
    backward: it writes every cell of d_img_feats and d_ray_feats
    [V,fh,fw,C] and, only if write_imgs, adds into d_imgs [V,H,W,3]. In
    float32 everything is float32; the bfloat16 instance
    (`epipolar_gather_backward_bf16`) takes bfloat16 maps' gradients and
    d_rgb, a float32 d_ray (ray_feats is float32, module docstring) and a
    float32 d_imgs, into which it adds each
    contribution rounded to bfloat16 (the caller rounds the sum once).
    Each call counts one launch of `epipolar_gather_backward` (a memset and
    three kernels on the card, `backward_cuda_launches`), the bfloat16 one
    in `bf16_launches` too."""
    bf16 = d_img_feats.dtype == BF16
    _check(d_imgs, d_img_feats, d_ray_feats, xy, valid, d_rgb, d_ray,
           (BF16,) if bf16 else (F32,), F32)
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
    fn = (lib.epipolar_gather_backward_bf16 if bf16
          else lib.epipolar_gather_backward)
    device = xy.device
    keep = (d_imgs, d_img_feats, d_ray_feats, xy, valid, d_rgb, d_ray, scratch)

    def launch():
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream().cuda_stream)
        build.check(status, "epipolar_gather_backward")
        epipolar_gather_backward.launches += 1
        epipolar_gather_backward.bf16_launches += bf16
        return keep[:3]   # the closure keeps all eight alive

    launch.index = (scratch, V, P, fh, fw, bf16)   # `backward_index_stats`
    return launch


def backward_cuda_launches() -> int:
    """CUDA launches (memsets included) of one backward call without
    d_imgs, as built (both instances)."""
    return library().epipolar_gather_backward_launches()


def backward_index_stats(launch) -> dict:
    """What the last call of a `backward_launcher` call put in its index:
    the longest tile list (entries, chunks of its instance's pull, work
    items it was cut into), the list entries, the tiles a view and the work
    items of each view."""
    scratch, V, P, fh, fw, bf16 = launch.index
    out = (ctypes.c_longlong * 5)()
    build.check(library().epipolar_gather_backward_layout(V, P, fh, fw, bf16,
                                                          out),
                "epipolar_gather_backward_layout")
    starts_at, nitems_at, tiles, chunk, split = out
    starts = scratch[starts_at:starts_at + V * (tiles + 1)].view(V, tiles + 1)
    lengths = starts[:, 1:] - starts[:, :-1]
    longest = int(lengths.max())
    chunks = -(-longest // chunk)
    return {"longest_list": longest, "longest_chunks": chunks,
            "longest_ranges": -(-chunks // split) if split else 1,
            "entries": int(lengths.sum()), "chunk": chunk,
            "split_chunks": split, "tiles": tiles,
            "work_items": scratch[nitems_at:nitems_at + V].tolist()}


def backward_kernel_info(dtype=F32) -> dict:
    """The `dtype` instance of the backward's kernels as built, on the
    current card: registers, spilled (local) bytes and static shared memory
    a thread block of the count, fill and pull kernels; the pull's dynamic
    shared memory and resident blocks per SM."""
    out = (ctypes.c_int * 11)()
    name = ("epipolar_gather_backward_bf16_info" if dtype == BF16
            else "epipolar_gather_backward_info")
    build.check(getattr(library(), name)(out), name)
    info = {f"{k}_{f}": out[3 * i + j]
            for i, k in enumerate(("count", "fill", "pull"))
            for j, f in enumerate(("registers", "spill_bytes", "static_smem"))}
    info.update(pull_dynamic_smem=out[9], pull_blocks_per_sm=out[10])
    return info


def _window(xy, h, w, fh, fw):
    """`_interp_from_win`'s (fused_gather.py:108-175) window anchor and
    weights for coords xy [V,P,2], op for op: the clipped anchor (sy, sx)
    [V,P] of the 2 x 2 window of quarter-res cells, the four cells' folded
    feature-map weights {(a, b): rw_a * cw_b} [V,P] (border-clamped taps
    summed into one cell, the other weighted 0), and the full-res RGB's
    8-slot row and column weights rw, cw [V,P,8] over the window's 8 x 8
    pixels."""
    x, y = xy[..., 0], xy[..., 1]
    # divisors on the device: CUDA divides by a host scalar through its
    # reciprocal, the kernel (and JAX) in IEEE division
    xn = x / xy.new_tensor(w - 1) * 2 - 1
    yn = y / xy.new_tensor(h - 1) * 2 - 1

    def quarter(n, size):
        q = ((n + 1.0) * size - 1.0) * 0.5
        q0 = torch.floor(q)
        i = q0.to(torch.int64)
        s = i.clamp(0, size - 2)
        o0, o1 = i.clamp(0, size - 1) - s, (i + 1).clamp(0, size - 1) - s
        wt = q - q0
        zero = torch.zeros_like(wt)
        return s, [torch.where(o0 == k, 1 - wt, zero)
                   + torch.where(o1 == k, wt, zero) for k in (0, 1)]

    sy, rws = quarter(yn, fh)
    sx, cws = quarter(xn, fw)
    cell_w = {(a, b): rws[a] * cws[b] for a in (0, 1) for b in (0, 1)}

    def full(n, size, s):
        f = (n + 1.0) * 0.5 * (size - 1)
        f0 = torch.floor(f)
        i = f0.to(torch.int64)
        wt = (f - f0)[..., None]
        slots = torch.arange(8, device=xy.device)
        u0 = (i.clamp(0, size - 1) - 4 * s).clamp(0, 7)[..., None]
        u1 = ((i + 1).clamp(0, size - 1) - 4 * s).clamp(0, 7)[..., None]
        zero = torch.zeros_like(wt)
        return (torch.where(u0 == slots, 1 - wt, zero)
                + torch.where(u1 == slots, wt, zero))

    return sy, sx, cell_w, full(yn, 4 * fh, sy), full(xn, 4 * fw, sx)


def _splat_bf16(contribs, index, cells: int):
    """Each contribution rounded to bfloat16, summed per cell in float32,
    each cell rounded to bfloat16 once: contribs [n,K] float32 at flat
    cells index [n] of `cells` -> [cells,K] bfloat16."""
    acc = contribs.new_zeros((cells, contribs.shape[-1]))
    acc.index_add_(0, index, contribs.to(BF16).float())
    return acc.to(BF16)


def _backward_plain_bf16(imgs_shape, maps_shape, xy, valid, d_rgb, d_ray,
                         need_imgs):
    """`_feg_bwd` (fused_gather.py:260-270) on bfloat16 maps: the VJP of
    `_interp_from_win` per point (the float32 upstream times the mask,
    times each window cell's folded weight; for the RGB, times the row
    weight then the column weight), rounded to bfloat16 as the transpose
    of the promotion, then `_splat_windows`' float32 sum per map cell and
    the one rounding of `d_packed.astype(bfloat16)`."""
    V, H, W, _ = imgs_shape
    _, fh, fw, C = maps_shape
    xy = xy.detach()
    sy, sx, cell_w, rw, cw = _window(xy, H, W, fh, fw)
    m = valid.to(F32)[..., None]
    g = torch.cat([d_rgb[..., 3:].float(), d_ray.float()], -1) * m
    view = torch.arange(V, device=xy.device)[:, None]
    contribs, index = [], []
    for (a, b), wt in cell_w.items():
        contribs.append(g * wt[..., None])
        index.append((view * fh + sy + a) * fw + sx + b)
    d = _splat_bf16(torch.cat(contribs, 1).reshape(-1, 2 * C),
                    torch.cat(index, 1).reshape(-1), V * fh * fw)
    d = d.reshape(V, fh, fw, 2 * C)
    d_imgs = None
    if need_imgs:
        g_rgb = d_rgb[..., :3].float() * m
        # [V,P,8 rows,8 columns,3]: (upstream x row weight) x column weight
        pix = ((g_rgb[:, :, None, None] * rw[..., None, None])
               * cw[:, :, None, :, None])
        slots = torch.arange(8, device=xy.device)
        rows = (view[..., None] * H + 4 * sy[..., None] + slots)
        cols = 4 * sx[..., None] + slots
        index = rows[..., :, None] * W + cols[..., None, :]
        d_imgs = _splat_bf16(pix.reshape(-1, 3), index.reshape(-1),
                             V * H * W).reshape(imgs_shape)
    return d_imgs, d[..., :C].contiguous(), d[..., C:].contiguous()


def epipolar_gather_backward_plain(imgs_shape, maps_shape, xy, valid, d_rgb,
                                   d_ray, need_imgs: bool = False, dtype=F32):
    """Plain version of the backward for maps of `dtype`. float32: autograd
    through `epipolar_gather_plain` (the bilinear weights do not depend on
    the maps' values, so zero maps of the given shapes stand in for them).
    bfloat16: `_feg_bwd`'s arithmetic (`_backward_plain_bf16`), d_rgb and
    d_ray of any float dtype. -> (d_imgs [V,H,W,3] or None, d_img_feats,
    d_ray_feats [V,fh,fw,C]), in `dtype`."""
    if dtype == BF16:
        return _backward_plain_bf16(imgs_shape, maps_shape, xy, valid, d_rgb,
                                    d_ray, need_imgs)
    with torch.enable_grad():
        f = dict(dtype=torch.float32, device=xy.device, requires_grad=True)
        maps = [torch.zeros(imgs_shape, **f), torch.zeros(maps_shape, **f),
                torch.zeros(maps_shape, **f)]
        outs = epipolar_gather_plain(*maps, xy.detach(), valid)
        grads = torch.autograd.grad(outs, maps, (d_rgb, d_ray))
    return (grads[0] if need_imgs else None, grads[1], grads[2])


def epipolar_gather_backward(xy, valid, d_rgb, d_ray, imgs_shape, maps_shape,
                             need_imgs: bool = False, dtype=F32):
    """Backward wrapper for maps of `dtype`: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. d_rgb [V,P,3+C] and d_ray
    [V,P,C] are the gradients of the gather's two outputs -> (d_imgs
    [V,H,W,3], or None unless need_imgs, d_img_feats, d_ray_feats
    [V,fh,fw,C]), in `dtype`. On the card the bfloat16 instance reads d_ray
    in float32 (a bfloat16 one is widened first) and sums d_imgs in
    float32, rounded here once."""
    if xy.device.type == "cpu":
        return epipolar_gather_backward_plain(imgs_shape, maps_shape, xy,
                                              valid, d_rgb, d_ray, need_imgs,
                                              dtype)
    if xy.device.type != "cuda":
        raise ValueError(f"no gather backward for device {xy.device}")
    f = dict(dtype=dtype, device=xy.device)
    # d_imgs (float32) only when asked for (added into); otherwise an
    # unwritten stand-in that gives the kernel its H and W. The kernel
    # writes every cell of the maps' gradients.
    d_imgs = (torch.zeros if need_imgs else torch.empty)(
        imgs_shape, dtype=F32, device=xy.device)
    d_img_feats = torch.empty(maps_shape, **f)
    d_ray_feats = torch.empty(maps_shape, **f)
    backward_launcher(d_imgs, d_img_feats, d_ray_feats, xy, valid,
                      d_rgb.contiguous(), d_ray.to(F32).contiguous(),
                      need_imgs)()
    return (d_imgs.to(dtype) if need_imgs else None, d_img_feats,
            d_ray_feats)


def _slopes(fmap, px, py):
    """d/dpx and d/dpy of the border-clamped bilinear sample of fmap
    [V,h,w,c] at pixel coords px, py [V,P] (float32 values, floor and the
    clamps without gradient) -> two [V,P,c] float32: the differences of
    the taps, each weighted by the other axis' weights."""
    V, h, w, c = fmap.shape
    flat = fmap.reshape(V, h * w, c)
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = (px - x0)[..., None], (py - y0)[..., None]
    xi, yi = x0.to(torch.int64), y0.to(torch.int64)

    def tap(x, y):
        idx = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)).float()

    v00, v01 = tap(xi, yi), tap(xi + 1, yi)
    v10, v11 = tap(xi, yi + 1), tap(xi + 1, yi + 1)
    return ((v01 - v00) * (1 - wy) + (v11 - v10) * wy,
            (v10 - v00) * (1 - wx) + (v11 - v01) * wx)


def epipolar_gather_backward_xy_plain(imgs, img_feats, ray_feats, xy, valid,
                                      d_rgb, d_ray):
    """Plain version of the gradient with respect to xy: the xy cotangent of
    `_feg_bwd` (fused_gather.py:268), the VJP of `_interp_from_win`
    (:95-180) written out. The gather's maps (either dtype, read widened to
    float32 as JAX promotes the window), xy [V,P,2], valid [V,P] and the
    upstream d_rgb [V,P,3+C], d_ray [V,P,C] -> d_xy [V,P,2] float32. Per
    axis, the tap differences weighted by the other axis' weights (0 where
    the border clamps both taps onto one row or column: JAX's folded
    weights cancel there), contracted with the masked upstream (g * 0 is
    NaN where g is not finite, as in JAX), through dxq/dx = fw/(w-1) for
    the feature maps and dxf/dx = (W-1)/(w-1) for the image."""
    V, H, W, _ = imgs.shape
    fh, fw = img_feats.shape[1:3]
    xy = xy.detach()
    m = valid.to(F32)[..., None]
    g_rgb = d_rgb[..., :3].float() * m
    g_img, g_ray = d_rgb[..., 3:].float() * m, d_ray.float() * m
    xn = xy[..., 0] / xy.new_tensor(W - 1) * 2 - 1
    yn = xy[..., 1] / xy.new_tensor(H - 1) * 2 - 1
    qx, qy = ((xn + 1.0) * fw - 1.0) * 0.5, ((yn + 1.0) * fh - 1.0) * 0.5
    (ix, iy), (rx, ry) = (_slopes(f, qx, qy) for f in (img_feats, ray_feats))
    fx, fy = (xn + 1.0) * 0.5 * (W - 1), (yn + 1.0) * 0.5 * (H - 1)
    cx, cy = _slopes(imgs, fx, fy)
    d_xn = (((g_img * ix).sum(-1) + (g_ray * rx).sum(-1)) * (0.5 * fw)
            + (g_rgb * cx).sum(-1) * (0.5 * (W - 1)))
    d_yn = (((g_img * iy).sum(-1) + (g_ray * ry).sum(-1)) * (0.5 * fh)
            + (g_rgb * cy).sum(-1) * (0.5 * (H - 1)))
    return torch.stack([d_xn * 2 / xy.new_tensor(W - 1),
                        d_yn * 2 / xy.new_tensor(H - 1)], -1)


def backward_xy_launcher(imgs, img_feats, ray_feats, xy, valid, d_rgb, d_ray,
                         d_xy):
    """Check the CUDA tensors once (`_check`: d_rgb has rgb_feats' dtype,
    the maps', and d_ray ray_feats', float32) and return a call that
    launches `epipolar_gather_backward_xy` (or its bfloat16 instance, as
    the maps' dtype says), writing every element of d_xy [V,P,2] float32:
    the wrapper's launch and the bare launch chip_smoke.py times. Each call
    counts one launch."""
    _check(imgs, img_feats, ray_feats, xy, valid, d_rgb, d_ray)
    if d_xy.shape != xy.shape or d_xy.dtype != F32 or not (
            d_xy.is_contiguous() and d_xy.device == xy.device):
        raise ValueError("d_xy must be a contiguous float32 tensor of xy's "
                         "shape on its device")
    V, H, W, _ = imgs.shape
    _, fh, fw, C = img_feats.shape
    tensors = (imgs, img_feats, ray_feats, xy, valid, d_rgb, d_ray, d_xy)
    args = [t.data_ptr() for t in tensors] + [V, xy.shape[1], H, W, fh, fw, C]
    lib = library()
    fn = (lib.epipolar_gather_backward_xy_bf16 if img_feats.dtype == BF16
          else lib.epipolar_gather_backward_xy)
    device = xy.device

    def launch():
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream().cuda_stream)
        build.check(status, "epipolar_gather_backward_xy")
        epipolar_gather_backward_xy.launches += 1
        return tensors[7]   # the closure keeps all eight alive

    return launch


def epipolar_gather_backward_xy(imgs, img_feats, ray_feats, xy, valid, d_rgb,
                                d_ray):
    """The gradient with respect to xy: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. Arguments and result as
    `epipolar_gather_backward_xy_plain`; on the card d_rgb is taken in the
    maps' dtype and d_ray in float32 (the gather's output dtypes)."""
    if xy.device.type == "cpu":
        return epipolar_gather_backward_xy_plain(imgs, img_feats, ray_feats,
                                                 xy, valid, d_rgb, d_ray)
    if xy.device.type != "cuda":
        raise ValueError(f"no gather backward for device {xy.device}")
    d_xy = torch.empty(xy.shape, dtype=F32, device=xy.device)
    return backward_xy_launcher(imgs, img_feats, ray_feats, xy, valid,
                                d_rgb.contiguous(), d_ray.contiguous(),
                                d_xy)()


def backward_xy_kernel_info(dtype=F32) -> dict:
    """The xy kernel's `dtype` instance as built: registers, spilled (local)
    bytes and static shared memory a thread block."""
    out = (ctypes.c_int * 3)()
    build.check(library().epipolar_gather_backward_xy_info(
        int(dtype == BF16), out), "epipolar_gather_backward_xy_info")
    return dict(zip(("registers", "spill_bytes", "static_smem"), out))


class _GatherFn(torch.autograd.Function):
    """The gather with the maps' gradients (the image's when it requires
    one) and xy's when it requires one; valid gets none.
    plain: forward and backward are the plain versions (`use_kernels=False`
    on the card, and bfloat16 on the CPU); else the kernel forward and the
    backward wrappers."""

    @staticmethod
    def forward(ctx, plain, imgs, img_feats, ray_feats, xy, valid):
        maps = (imgs, img_feats, ray_feats) if xy.requires_grad else ()
        ctx.save_for_backward(xy, valid, *maps)
        ctx.shapes = (imgs.shape, img_feats.shape)
        ctx.plain, ctx.dtype = plain, img_feats.dtype
        fn = _plain if plain else _launch
        return fn(imgs, img_feats, ray_feats, xy, valid)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_rgb, d_ray):
        xy, valid, *maps = ctx.saved_tensors
        need = ctx.needs_input_grad[1:5]
        d_imgs = d_img_feats = d_ray_feats = d_xy = None
        if any(need[:3]):
            if ctx.plain:
                d_imgs, d_img_feats, d_ray_feats = (
                    epipolar_gather_backward_plain(
                        *ctx.shapes, xy, valid, d_rgb, d_ray, need[0],
                        ctx.dtype))
            else:
                d_imgs, d_img_feats, d_ray_feats = epipolar_gather_backward(
                    xy, valid, d_rgb, d_ray, *ctx.shapes, need[0], ctx.dtype)
        if need[3]:
            fn = (epipolar_gather_backward_xy_plain if ctx.plain
                  else epipolar_gather_backward_xy)
            d_xy = fn(*maps, xy, valid, d_rgb, d_ray)
        return (None, d_imgs, d_img_feats if need[1] else None,
                d_ray_feats if need[2] else None, d_xy, None)


def epipolar_gather(imgs, img_feats, ray_feats, xy, valid):
    """Gather wrapper: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. Same arguments and results as `epipolar_gather_plain`;
    differentiable with respect to the three maps, in float32 and in
    bfloat16 (`epipolar_gather_backward`), and with respect to xy
    (`epipolar_gather_backward_xy`)."""
    if imgs.device.type == "cpu":
        return epipolar_gather_plain(imgs, img_feats, ray_feats, xy, valid)
    if imgs.device.type != "cuda":
        raise ValueError(f"no gather for device {imgs.device}")
    if imgs.dtype == BF16 and not _needs_grad(imgs, img_feats, ray_feats, xy):
        return _launch(imgs, img_feats, ray_feats, xy, valid)
    return _GatherFn.apply(False, imgs, img_feats, ray_feats, xy, valid)


# launches of each kernel; of their bfloat16 instances alone
epipolar_gather.launches = 0
epipolar_gather.bf16_launches = 0
epipolar_gather_backward.launches = 0
epipolar_gather_backward.bf16_launches = 0
epipolar_gather_backward_xy.launches = 0
