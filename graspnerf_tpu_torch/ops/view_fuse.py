"""IBRNet-NeuS view fuse: the per-view MLP stack and the fusion across views.

Replaces the Pallas kernel `_kernel` / `view_fuse`
(graspnerf_tpu/ops/pallas/ibrnet_fuse.py:115-253); `view_fuse_plain` is the
port of its jnp oracle `view_fuse_reference` (:52-98). On CUDA tensors
`view_fuse` launches csrc/view_fuse.cu; its backward recomputes through the
plain version, as the JAX custom VJP does.

Inputs are [V,N,C] with V = 6 views leading: rgbf [V,N,35] (rgb | image
features), neur [V,N,32] (prob embedding), rdiff [V,N,4] (direction
difference | dot), mask [V,N,1]. `weights` are ten (weight [O,I], bias [O])
pairs in W_NAMES order (torch Linear layout), float32. Outputs: feat_const
[N,65] (mean | var | mean weight), num_valid [N,1] (exact mask count),
x [V,N,32], vis [V,N,1].

`dtype` is the Pallas kernel's static dtype, float32 or bfloat16. In
bfloat16 the inputs are bfloat16 and the computation is the kernel's
(ibrnet_fuse.py:115-184 with dtype=bfloat16), not its jnp oracle's: each
layer's input and weight are rounded to bfloat16 and their products summed
in float32 with the float32 bias; every nonlinearity, residual, mean and
variance stays float32; x, vis and feat_const are rounded to bfloat16 on
output (:221-227), num_valid stays float32.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import build

V_VIEWS = 6
C_RGBF, C_NEUR, C_DIFF, C_X, C_OUT = 35, 32, 4, 32, 65
W_NAMES = ("ray_dir_fc.0", "ray_dir_fc.2", "neuray_fc.0", "neuray_fc.2",
           "base_fc.0", "base_fc.2", "vis_fc.0", "vis_fc.2",
           "vis_fc2.0", "vis_fc2.2")
# (in, out) of each Linear in W_NAMES order; csrc/view_fuse.cu has the same
LAYER_DIMS = ((4, 16), (16, 35), (32, 8), (8, 1), (207, 64), (64, 32),
              (32, 32), (32, 33), (32, 32), (32, 1))


def _pad4(o: int) -> int:
    return -(-o // 4) * 4


# Floats in pack_weights' buffer; the kernel library states its own
# (view_fuse_pack_floats) and the wrapper refuses a library that differs.
PACK_FLOATS = sum((i + 1) * _pad4(o) for i, o in LAYER_DIMS)

Pair = Tuple[torch.Tensor, torch.Tensor]
F32, BF16 = torch.float32, torch.bfloat16
_lib = None
_pack_cache: list = []   # [(weights, (versions, device, dtype), pack)]


def _weighted_mean_var(x, w):
    mean = torch.sum(x * w, 0)
    var = torch.sum(w * (x - mean[None]) ** 2, 0)
    return mean, var


def view_fuse_plain(rgbf, neur, rdiff, mask, weights: Sequence[Pair],
                    dtype=F32):
    """Plain PyTorch version: in float32 the port of `view_fuse_reference`,
    in bfloat16 what the Pallas kernel computes (the module docstring)."""
    (wd0, wd1, wn0, wn1, wb0, wb1, wv0, wv1, wv20, wv21) = weights
    if dtype == F32:
        mm = F.linear
    else:
        def mm(x, w, b):
            return F.linear(x.to(dtype).float(), w.to(dtype).float(),
                            b.float())
    rgbf, neur, rdiff, mask = (t.float() for t in (rgbf, neur, rdiff, mask))
    df = F.elu(mm(F.elu(mm(rdiff, *wd0)), *wd1))
    rf = rgbf + df

    weight = mask / (torch.sum(mask, 0, keepdim=True) + 1e-8)
    w0 = torch.sigmoid(mm(F.elu(mm(neur, *wn0)), *wn1)) * weight
    mean0, var0 = _weighted_mean_var(rf, w0)
    mean1, var1 = _weighted_mean_var(rf, weight)
    gf = torch.cat([mean0, var0, mean1, var1], -1)             # [N,140]

    V = rgbf.shape[0]
    xin = torch.cat([gf[None].expand(V, -1, -1), rf, neur], -1)  # [V,N,207]
    x = F.elu(mm(F.elu(mm(xin, *wb0)), *wb1))
    xv = F.elu(mm(F.elu(mm(x * weight, *wv0)), *wv1))
    x = x + xv[..., :C_X]
    vis = torch.sigmoid(xv[..., C_X:]) * mask
    vis = torch.sigmoid(mm(F.elu(mm(x * vis, *wv20)), *wv21)) * mask

    weight2 = vis / (torch.sum(vis, 0, keepdim=True) + 1e-8)
    mean, var = _weighted_mean_var(x, weight2)
    feat_const = torch.cat([mean, var, torch.mean(weight2, 0)], -1)
    return (feat_const.to(dtype), torch.sum(mask, 0), x.to(dtype),
            vis.to(dtype))


def pack_weights(weights: Sequence[Pair], dtype=F32) -> torch.Tensor:
    """The kernel's weight buffer, float32: each weight (rounded to `dtype`)
    transposed to [I][O4] (O padded with zeros to a multiple of 4, for
    float4 reads), all weights in W_NAMES order, then all biases (float32)
    padded to O4."""
    ws, bs = [], []
    for (w, b), (i, o) in zip(weights, LAYER_DIMS):
        if tuple(w.shape) != (o, i) or tuple(b.shape) != (o,):
            raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)}"
                             f" is not Linear({i}, {o})")
        o4 = _pad4(o)
        w = w.detach().to(dtype).to(F32)
        ws.append(F.pad(w.t(), (0, o4 - o)).reshape(-1))
        bs.append(F.pad(b.detach().to(F32), (0, o4 - o)))
    return torch.cat(ws + bs).contiguous()


def _packed(weights: Sequence[Pair], device, dtype=F32) -> torch.Tensor:
    """pack_weights(weights, dtype) on `device`, kept for the next call:
    packed again only when a weight is another tensor or was changed in
    place (its version counter moved), or for another dtype. The kept
    tensors cannot be freed, so a new weight never takes an old one's
    identity."""
    flat = tuple(t for pair in weights for t in pair)
    if any(t.is_inference() for t in flat):     # they keep no version
        return pack_weights(weights, dtype).to(device)
    key = (tuple(t._version for t in flat), device, dtype)
    if _pack_cache:
        kept, kept_key, pack = _pack_cache[0]
        if (kept_key == key and len(kept) == len(flat)
                and all(a is b for a, b in zip(kept, flat))):
            return pack
    pack = pack_weights(weights, dtype).to(device)
    _pack_cache[:] = [(flat, key, pack)]
    return pack


def check_pack(lib: ctypes.CDLL, pack_floats: int) -> None:
    """Raise unless the kernel library reads a `pack_floats`-float pack."""
    expect = lib.view_fuse_pack_floats()
    if expect != pack_floats:
        raise RuntimeError(f"view_fuse: the kernel reads a {expect}-float "
                           f"weight pack, pack_weights gives {pack_floats}")


def library(pack_floats: int = PACK_FLOATS) -> ctypes.CDLL:
    """The kernel's library, checked against the pack size at first load."""
    global _lib
    if _lib is None:
        lib = build.load("view_fuse")
        for name in ("view_fuse_pack_floats", "view_fuse_tile_rows"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        check_pack(lib, pack_floats)
        for name in ("view_fuse_forward", "view_fuse_forward_bf16"):
            getattr(lib, name).argtypes = ([ctypes.c_void_p] * 9
                                           + [ctypes.c_int, ctypes.c_void_p])
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(rgbf, neur, rdiff, mask, weights: Sequence[Pair], dtype=F32):
    V, N = rgbf.shape[:2]
    shapes = ((rgbf, C_RGBF), (neur, C_NEUR), (rdiff, C_DIFF), (mask, 1))
    if dtype not in (F32, BF16):
        raise TypeError(f"no view-fuse kernel for {dtype}")
    for t, c in shapes:
        if tuple(t.shape) != (V_VIEWS, N, c):
            raise ValueError(f"input {tuple(t.shape)} is not "
                             f"[{V_VIEWS},{N},{c}]")
        if t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"kernel takes contiguous {dtype} inputs")
        if t.device != rgbf.device:
            raise ValueError("all tensors must lie on one device")
    wpack = _packed(weights, rgbf.device, dtype)
    dev = dict(dtype=dtype, device=rgbf.device)
    feat_const = torch.empty((N, C_OUT), **dev)
    num_valid = torch.empty((N, 1), dtype=F32, device=rgbf.device)
    x = torch.empty((V, N, C_X), **dev)
    vis = torch.empty((V, N, 1), **dev)
    lib = library(wpack.numel())
    fn = lib.view_fuse_forward if dtype == F32 else lib.view_fuse_forward_bf16
    with torch.cuda.device(rgbf.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(rgbf.data_ptr(), neur.data_ptr(), rdiff.data_ptr(),
                    mask.data_ptr(), wpack.data_ptr(), feat_const.data_ptr(),
                    num_valid.data_ptr(), x.data_ptr(), vis.data_ptr(), N,
                    stream)
    build.check(status, "view_fuse")
    view_fuse.launches += 1
    if dtype == BF16:
        view_fuse.bf16_launches += 1
    return feat_const, num_valid, x, vis


class _ViewFuseFn(torch.autograd.Function):
    """Kernel forward; backward = autograd through the plain version
    (recompute, as `_vf_bwd` in the JAX package)."""

    @staticmethod
    def forward(ctx, dtype, rgbf, neur, rdiff, mask, *flat_w):
        ctx.save_for_backward(rgbf, neur, rdiff, mask, *flat_w)
        ctx.dtype = dtype
        pairs = list(zip(flat_w[0::2], flat_w[1::2]))
        return _launch(rgbf, neur, rdiff, mask, pairs, dtype)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            flat_w = ins[4:]
            outs = view_fuse_plain(*ins[:4],
                                   list(zip(flat_w[0::2], flat_w[1::2])),
                                   ctx.dtype)
            wrt = [t for t in ins if t.requires_grad]
            # num_valid = sum(mask) has no graph unless mask needs a grad
            live = [(o, torch.zeros_like(o) if g is None else g)
                    for o, g in zip(outs, grads) if o.requires_grad]
            gs = iter(torch.autograd.grad(
                [o for o, _ in live], wrt, [g for _, g in live],
                allow_unused=True))
        return (None, *(next(gs) if n else None for n in need))


def view_fuse(rgbf, neur, rdiff, mask, weights: Sequence[Pair], dtype=F32):
    """View-fuse wrapper: the CUDA kernel on CUDA tensors (float32 or
    bfloat16, as `dtype` says), the plain version on CPU tensors. Same
    arguments and results as `view_fuse_plain`."""
    if rgbf.device.type == "cpu":
        return view_fuse_plain(rgbf, neur, rdiff, mask, weights, dtype)
    if rgbf.device.type != "cuda":
        raise ValueError(f"no view fuse for device {rgbf.device}")
    flat_w = [t for pair in weights for t in pair]
    return _ViewFuseFn.apply(dtype, rgbf, neur, rdiff, mask, *flat_w)


# launches of the kernel, of both dtypes; and of its bfloat16 instance
view_fuse.launches = 0
view_fuse.bf16_launches = 0
