"""IBRNet-NeuS view fuse: the per-view MLP stack and the fusion across views.

Replaces the Pallas kernel `_kernel` / `view_fuse`
(graspnerf_tpu/ops/pallas/ibrnet_fuse.py:115-253); `view_fuse_plain` is the
port of its jnp oracle `view_fuse_reference` (:52-98) in float32 and of the
kernel's arithmetic in bfloat16, `view_fuse_reference` the oracle's in
both. On CUDA tensors `view_fuse` launches csrc/view_fuse.cu (float32) or
csrc/view_fuse_bf16.cu (bfloat16). Its backward recomputes through
`view_fuse_reference`, as the JAX custom VJP `_vf_bwd` (:245-250) does:
in bfloat16 the oracle rounds every layer's output to bfloat16 (`_mm`,
:45-49), where the forward rounds operands only; `view_fuse_plain` with a
bfloat16 gradient takes the same split.

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

# pack_weights_bf16's blocks of mma B fragments, K x N zero-padded to
# multiples of 16 x 8: (layer, [(k, input channel, count), ...], K, N).
# base_fc.0 is split as the bfloat16 kernel computes it: its gf block
# (channels 0..139) once per row, and its per-view block on [rf | 0 | neur]
# (rf at k 0..34, neur at k 48..79: each starts a k16 step's fragments).
BF16_BLOCKS = (
    (0, [(0, 0, 4)], 16, 16), (1, [(0, 0, 16)], 16, 40),
    (2, [(0, 0, 32)], 32, 8), (3, [(0, 0, 8)], 16, 8),
    (4, [(0, 0, 140)], 144, 64), (4, [(0, 140, 35), (48, 175, 32)], 80, 64),
    (5, [(0, 0, 64)], 64, 32), (6, [(0, 0, 32)], 32, 32),
    (7, [(0, 0, 32)], 32, 40), (8, [(0, 0, 32)], 32, 32),
    (9, [(0, 0, 32)], 32, 8))
# each layer's bias, float32, padded to its block's N
BF16_BIAS_N = (16, 40, 8, 8, 64, 32, 32, 40, 32, 8)
# bfloat16 elements of pack_weights_bf16's buffer; the library states its
# own (view_fuse_bf16_pack_elems)
PACK_BF16_ELEMS = (sum(k * n for _, _, k, n in BF16_BLOCKS)
                   + 2 * sum(BF16_BIAS_N))

Pair = Tuple[torch.Tensor, torch.Tensor]
F32, BF16 = torch.float32, torch.bfloat16
_libs: dict = {}          # dtype -> loaded kernel library
_pack_cache: dict = {}    # dtype -> (weights, (versions, device), pack)


def _weighted_mean_var(x, w):
    mean = torch.sum(x * w, 0)
    var = torch.sum(w * (x - mean[None]) ** 2, 0)
    return mean, var


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def view_fuse_plain(rgbf, neur, rdiff, mask, weights: Sequence[Pair],
                    dtype=F32):
    """Plain PyTorch version: in float32 the port of `view_fuse_reference`,
    in bfloat16 what the Pallas kernel computes (the module docstring). In
    float32 autograd differentiates it; in bfloat16 with a gradient it is
    `_ViewFuseFn` on this forward, whose backward recomputes through
    `view_fuse_reference`, as `_vf_bwd` does."""
    flat_w = [t for pair in weights for t in pair]
    if dtype == BF16 and _needs_grad(rgbf, neur, rdiff, mask, *flat_w):
        return _ViewFuseFn.apply(dtype, True, rgbf, neur, rdiff, mask,
                                 *flat_w)
    return _plain(rgbf, neur, rdiff, mask, weights, dtype)


def _plain(rgbf, neur, rdiff, mask, weights: Sequence[Pair], dtype=F32):
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


def view_fuse_reference(rgbf, neur, rdiff, mask, weights: Sequence[Pair],
                        dtype=F32):
    """`view_fuse_reference` (ibrnet_fuse.py:52-98): in float32
    `view_fuse_plain`; in bfloat16 the inputs rounded to it and each
    layer's output rounded to bfloat16 after its float32 sum of products
    of bfloat16 operands and its float32 bias, as `_mm` (:45-49) rounds
    it; the elementwise ops between in float32, as XLA's fusions evaluate
    the oracle's bfloat16 elementwise ops; feat_const, x and vis rounded on
    output. The bfloat16 backward differentiates this."""
    if dtype == F32:
        return _plain(rgbf, neur, rdiff, mask, weights, dtype)
    (wd0, wd1, wn0, wn1, wb0, wb1, wv0, wv1, wv20, wv21) = weights

    def mm(x, w, b):
        return (F.linear(x.to(dtype).float(), w.to(dtype).float())
                + b.float()).to(dtype).float()

    rgbf, neur, rdiff, mask = (t.to(dtype).float()
                               for t in (rgbf, neur, rdiff, mask))
    df = F.elu(mm(F.elu(mm(rdiff, *wd0)), *wd1))
    rf = rgbf + df

    weight = mask / (torch.sum(mask, 0, keepdim=True) + 1e-8)
    w0 = torch.sigmoid(mm(F.elu(mm(neur, *wn0)), *wn1)) * weight
    mean0, var0 = _weighted_mean_var(rf, w0)
    mean1, var1 = _weighted_mean_var(rf, weight)
    gf = torch.cat([mean0, var0, mean1, var1], -1)

    V = rgbf.shape[0]
    xin = torch.cat([gf[None].expand(V, -1, -1), rf, neur], -1)
    x = F.elu(mm(F.elu(mm(xin, *wb0)), *wb1))
    xv = F.elu(mm(F.elu(mm(x * weight, *wv0)), *wv1))
    vis = torch.sigmoid(xv[..., C_X:]) * mask
    x = x + xv[..., :C_X]
    vis = torch.sigmoid(mm(F.elu(mm(x * vis, *wv20)), *wv21)) * mask

    weight2 = vis / (torch.sum(vis, 0, keepdim=True) + 1e-8)
    mean, var = _weighted_mean_var(x, weight2)
    feat_const = torch.cat([mean, var, torch.mean(weight2, 0)], -1)
    return (feat_const.to(dtype), torch.sum(mask, 0), x.to(dtype),
            vis.to(dtype))


def _check_shapes(weights: Sequence[Pair]) -> None:
    for (w, b), (i, o) in zip(weights, LAYER_DIMS):
        if tuple(w.shape) != (o, i) or tuple(b.shape) != (o,):
            raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)}"
                             f" is not Linear({i}, {o})")


def pack_weights(weights: Sequence[Pair]) -> torch.Tensor:
    """The float32 kernel's weight buffer: each weight transposed to [I][O4]
    (O padded with zeros to a multiple of 4, for float4 reads), all weights
    in W_NAMES order, then all biases padded to O4."""
    _check_shapes(weights)
    ws, bs = [], []
    for (w, b), (i, o) in zip(weights, LAYER_DIMS):
        o4 = _pad4(o)
        ws.append(F.pad(w.detach().to(F32).t(), (0, o4 - o)).reshape(-1))
        bs.append(F.pad(b.detach().to(F32), (0, o4 - o)))
    return torch.cat(ws + bs).contiguous()


def pack_weights_bf16(weights: Sequence[Pair]) -> torch.Tensor:
    """The bfloat16 kernel's weight buffer, PACK_BF16_ELEMS bfloat16: the
    weights rounded to bfloat16 as BF16_BLOCKS' blocks of mma.m16n8k16 B
    fragments, then the biases, float32, padded to BF16_BIAS_N (their bytes
    viewed as bfloat16 pairs).

    A block W [K][N] (W[k][n] = weight[n][input channel of k], zeros in the
    padding) is stored k16 step by k16 step s, in each n8 tile by n8 tile
    j, in each 32 lanes of 4 values: lane 4g + t holds W[16s + 2t + {0, 1,
    8, 9}][8j + g], the B fragment (two 32-bit registers) of its lane."""
    _check_shapes(weights)
    ws = []
    for layer, spans, k, n in BF16_BLOCKS:
        w = weights[layer][0].detach().to(F32)
        dense = torch.zeros(k, n, device=w.device)
        for k0, c0, cnt in spans:
            dense[k0:k0 + cnt, :w.shape[0]] = w[:, c0:c0 + cnt].t()
        # [s, half, t, pair, j, g] -> [s, j, g, t, half, pair]
        ws.append(dense.reshape(k // 16, 2, 4, 2, n // 8, 8)
                  .permute(0, 4, 5, 2, 1, 3).reshape(-1))
    bs = [F.pad(b.detach().to(F32), (0, n - b.shape[0]))
          for (_, b), n in zip(weights, BF16_BIAS_N)]
    return torch.cat([torch.cat(ws).to(BF16),
                      torch.cat(bs).view(BF16)]).contiguous()


_PACKERS = {F32: pack_weights, BF16: pack_weights_bf16}


def _packed(weights: Sequence[Pair], device, dtype=F32) -> torch.Tensor:
    """The `dtype` kernel's weight pack on `device`, kept for the next call,
    one per dtype: packed again only when a weight is another tensor or was
    changed in place (its version counter moved), or for another device.
    The kept tensors cannot be freed, so a new weight never takes an old
    one's identity."""
    pack_fn = _PACKERS[dtype]
    flat = tuple(t for pair in weights for t in pair)
    if any(t.is_inference() for t in flat):     # they keep no version
        return pack_fn(weights).to(device)
    key = (tuple(t._version for t in flat), device)
    if dtype in _pack_cache:
        kept, kept_key, pack = _pack_cache[dtype]
        if (kept_key == key and len(kept) == len(flat)
                and all(a is b for a, b in zip(kept, flat))):
            return pack
    pack = pack_fn(weights).to(device)
    _pack_cache[dtype] = (flat, key, pack)
    return pack


# per dtype: the csrc source, its pack-size and row-tile functions, the
# pack's size, its forward entry point
_LIB_SPEC = {
    F32: ("view_fuse", "view_fuse_pack_floats", "view_fuse_tile_rows",
          PACK_FLOATS, "view_fuse_forward"),
    BF16: ("view_fuse_bf16", "view_fuse_bf16_pack_elems",
           "view_fuse_bf16_slab_rows", PACK_BF16_ELEMS,
           "view_fuse_bf16_forward")}


def check_pack(lib: ctypes.CDLL, pack_size: int, dtype=F32) -> None:
    """Raise unless the `dtype` kernel library reads a pack of `pack_size`
    elements."""
    expect = getattr(lib, _LIB_SPEC[dtype][1])()
    if expect != pack_size:
        raise RuntimeError(f"view_fuse: the {dtype} kernel reads a "
                           f"{expect}-element weight pack, its packer gives "
                           f"{pack_size}")


def library(dtype=F32) -> ctypes.CDLL:
    """The `dtype` kernel's library, checked against the pack size at first
    load."""
    if dtype not in _libs:
        name, size_fn, rows_fn, size, forward = _LIB_SPEC[dtype]
        lib = build.load(name)
        for fn in (size_fn, rows_fn):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = []
        check_pack(lib, size, dtype)
        getattr(lib, forward).argtypes = ([ctypes.c_void_p] * 9
                                          + [ctypes.c_int, ctypes.c_void_p])
        getattr(lib, forward).restype = ctypes.c_int
        if dtype == BF16:
            lib.view_fuse_bf16_info.argtypes = [ctypes.c_void_p]
            lib.view_fuse_bf16_info.restype = ctypes.c_int
        _libs[dtype] = lib
    return _libs[dtype]


def kernel_info() -> dict:
    """The bfloat16 kernel as built, on the current card: registers and
    spilled (local) bytes a thread, shared memory and threads a block,
    resident blocks per SM."""
    out = (ctypes.c_int * 5)()
    build.check(library(BF16).view_fuse_bf16_info(out), "view_fuse_bf16")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm", "threads"), out))


def launcher(rgbf, neur, rdiff, mask, weights: Sequence[Pair], outs,
             dtype=F32):
    """Check the CUDA tensors once and return a call that launches the
    `dtype` kernel on them, writing `outs` (feat_const, num_valid, x, vis):
    the wrapper's launch, and the bare launch that chip_smoke.py times. Each
    call counts one launch."""
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
    out_shapes = ((N, C_OUT), (N, 1), (V, N, C_X), (V, N, 1))
    for t, shape, dt in zip(outs, out_shapes, (dtype, F32, dtype, dtype)):
        if tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"output {tuple(t.shape)} {t.dtype} is not a "
                             f"contiguous {shape} {dt}")
    if any(t.device != rgbf.device for t in (neur, rdiff, mask, *outs)):
        raise ValueError("all tensors must lie on one device")
    wpack = _packed(weights, rgbf.device, dtype)
    fn = getattr(library(dtype), _LIB_SPEC[dtype][4])
    tensors = (rgbf, neur, rdiff, mask, wpack, *outs)
    args = [t.data_ptr() for t in tensors] + [N]
    device = rgbf.device

    def launch():
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream().cuda_stream)
        build.check(status, "view_fuse")
        view_fuse.launches += 1
        view_fuse.bf16_launches += dtype == BF16
        return tensors[5:]    # the closure keeps every tensor alive

    return launch


def _launch(rgbf, neur, rdiff, mask, weights: Sequence[Pair], dtype=F32):
    V, N = rgbf.shape[:2]
    dev = dict(dtype=dtype, device=rgbf.device)
    outs = (torch.empty((N, C_OUT), **dev),
            torch.empty((N, 1), dtype=F32, device=rgbf.device),
            torch.empty((V, N, C_X), **dev), torch.empty((V, N, 1), **dev))
    return launcher(rgbf, neur, rdiff, mask, weights, outs, dtype)()


class _ViewFuseFn(torch.autograd.Function):
    """Forward: the kernel, or the plain version when `plain`; backward =
    autograd through `view_fuse_reference` (recompute, as `_vf_bwd` in the
    JAX package)."""

    @staticmethod
    def forward(ctx, dtype, plain, rgbf, neur, rdiff, mask, *flat_w):
        ctx.save_for_backward(rgbf, neur, rdiff, mask, *flat_w)
        ctx.dtype = dtype
        pairs = list(zip(flat_w[0::2], flat_w[1::2]))
        if plain:
            return _plain(rgbf, neur, rdiff, mask, pairs, dtype)
        return _launch(rgbf, neur, rdiff, mask, pairs, dtype)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            flat_w = ins[4:]
            outs = view_fuse_reference(*ins[:4],
                                       list(zip(flat_w[0::2], flat_w[1::2])),
                                       ctx.dtype)
            wrt = [t for t in ins if t.requires_grad]
            # num_valid = sum(mask) has no graph unless mask needs a grad
            live = [(o, torch.zeros_like(o) if g is None else g)
                    for o, g in zip(outs, grads) if o.requires_grad]
            gs = iter(torch.autograd.grad(
                [o for o, _ in live], wrt, [g for _, g in live],
                allow_unused=True))
        return (None, None, *(next(gs) if n else None for n in need))


def view_fuse(rgbf, neur, rdiff, mask, weights: Sequence[Pair], dtype=F32):
    """View-fuse wrapper: the CUDA kernel on CUDA tensors (float32 or
    bfloat16, as `dtype` says), the plain version on CPU tensors. Same
    arguments, results and gradients as `view_fuse_plain`."""
    if rgbf.device.type == "cpu":
        return view_fuse_plain(rgbf, neur, rdiff, mask, weights, dtype)
    if rgbf.device.type != "cuda":
        raise ValueError(f"no view fuse for device {rgbf.device}")
    flat_w = [t for pair in weights for t in pair]
    if not _needs_grad(rgbf, neur, rdiff, mask, *flat_w):
        return _launch(rgbf, neur, rdiff, mask, weights, dtype)
    return _ViewFuseFn.apply(dtype, False, rgbf, neur, rdiff, mask, *flat_w)


# launches of the kernel, of both dtypes; and of its bfloat16 instance
view_fuse.launches = 0
view_fuse.bf16_launches = 0
