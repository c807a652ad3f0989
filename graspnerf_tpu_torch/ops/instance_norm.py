"""InstanceNorm fused with what surrounds it in the view encoders
(models/nn_blocks.py): one launch a norm in place of the chain
`F.instance_norm` (two repeats of its weight and bias, a batch norm) ->
residual add -> ReLU / ELU -> `F.pad(reflect)` of the next convolution.

    s = x (+ add)                    the pre-norm shortcut sum
    y = act(instance_norm(s) * w + b (+ residual))
    -> NormOut(sum = s where add is given, out = y where unpadded,
               padded = F.pad(y, (pad,) * 4, "reflect") where pad > 0,
               or with `up` F.pad(upsample_x2(y), ...))

`add` is ResidualBlock's shortcut, summed before the next block's norm;
`residual` is BasicBlock's, added after the affine. The padded output can
be written into `padded`, a [V, C, H+2p, W+2p] channel slice of a larger
buffer (the concatenation a decoder convolution reads). With `up` it is
the bilinear x2 upsampling of y (align_corners, `UpConv`'s), padded:
[V, C, 2H+2p, 2W+2p], the input of the decoder's next convolution.

`instance_norm_act_plain` is the chain itself, op for op, so the CPU and
every caller outside the kernel's rule keep its bits. On CUDA tensors
`instance_norm_act` launches csrc/instance_norm.cu (float32, no autograd:
the encoders call it only with autograd off); on CPU tensors it runs the
plain chain. The kernel's statistics are float32 from its on-chip copy of
the plane: the mean, then the biased variance as the mean of squared
deviations; it differs from the chain's batch norm by rounding only.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import build
from .interpolate import resize_bilinear_align_corners

F32 = torch.float32
ACTS = {None: 0, "relu": 1, "elu": 2}
_ACT_FNS = {None: lambda y: y, "relu": F.relu, "elu": F.elu}

# launch plan: a block a plane, the plane in the block's shared memory
# (MAX_DYNAMIC_SMEM bytes: an H100's 232,448 less the kernel's static
# shared memory and a margin; larger planes are refused); threads the power
# of two at or above THREADS_PER_ROOT times the square root of a plane's
# floats, 64 to MAX_THREADS (the fastest of 64-1,024 threads at each of the
# encoders' plane sizes on an H100, PERF.md)
MAX_DYNAMIC_SMEM = 232448 - 1024
THREADS_PER_ROOT = 4
MAX_PAD = 3
# csrc/instance_norm.cu's most threads a block (checked at load)
MAX_THREADS = 1024

_lib = None


class NormOut(NamedTuple):
    sum: Optional[torch.Tensor]     # x + add, where add was given
    out: Optional[torch.Tensor]     # y, where unpadded
    padded: Optional[torch.Tensor]  # y (upsampled) reflect-padded by pad


def instance_norm_act_plain(x, weight, bias, act=None, *, add=None,
                            residual=None, pad: int = 0, up: bool = False,
                            unpadded: bool = True, padded=None,
                            eps: float = 1e-5) -> NormOut:
    """The chain the kernel replaces, as the encoders' modules run it."""
    s = x if add is None else x + add
    y = F.instance_norm(s, weight=weight, bias=bias, eps=eps)
    if residual is not None:
        y = y + residual
    y = _ACT_FNS[act](y)
    yp = None
    if pad:
        h, w = y.shape[-2:]
        yp = F.pad(resize_bilinear_align_corners(y, 2 * h, 2 * w) if up
                   else y, (pad,) * 4, mode="reflect")
        if padded is not None:
            padded.copy_(yp)
            yp = padded
    return NormOut(None if add is None else s, y if unpadded else None, yp)


def launch_plan(h: int, w: int) -> Optional[Tuple[int, int]]:
    """(threads, dynamic shared memory bytes) of a launch over planes of
    h x w, a block a plane. None where a plane does not fit in one block's
    shared memory."""
    if 4 * h * w > MAX_DYNAMIC_SMEM:
        return None
    threads = 1 << math.ceil(math.log2(THREADS_PER_ROOT * math.sqrt(h * w)))
    return max(64, min(MAX_THREADS, threads)), 4 * h * w


def library() -> ctypes.CDLL:
    """The kernel's library, its entry points typed and its constants
    checked at first load."""
    global _lib
    if _lib is None:
        lib = build.load("instance_norm")
        fn = lib.instance_norm_max_threads
        fn.argtypes, fn.restype = [], ctypes.c_int
        if fn() != MAX_THREADS:
            raise RuntimeError(f"instance_norm: the library takes {fn()} "
                               f"threads a block, its wrapper {MAX_THREADS}")
        lib.instance_norm_act_forward.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 7
            + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.instance_norm_act_forward.restype = ctypes.c_int
        lib.instance_norm_act_info.argtypes = [ctypes.c_void_p]
        lib.instance_norm_act_info.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_info() -> dict:
    """The kernel as built, on the current card: registers and spilled
    (local) bytes a thread, static shared memory, most threads a block."""
    out = (ctypes.c_int * 4)()
    build.check(library().instance_norm_act_info(out),
                "instance_norm_act")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "max_threads"), out))


def _check(x, weight, bias, add, residual, pad, up, padded):
    if x.dim() != 4 or x.dtype != F32 or not x.is_contiguous():
        raise TypeError("instance_norm_act: x must be a contiguous float32 "
                        f"[V,C,H,W], not {x.dtype} {tuple(x.shape)}")
    V, C, H, W = x.shape
    for t in (add, residual):
        if t is not None and (t.shape != x.shape or t.dtype != F32
                              or not t.is_contiguous()):
            raise ValueError("instance_norm_act: add and residual must be "
                             "contiguous float32 tensors of x's shape")
    for t in (weight, bias):
        if (t.shape != (C,) or t.dtype != F32 or not t.is_contiguous()):
            raise ValueError(f"instance_norm_act: weight and bias must be "
                             f"contiguous float32 [{C}]")
    f = 2 if up else 1
    if not 0 <= pad <= MAX_PAD or pad >= f * min(H, W) or (up and not pad):
        raise ValueError(f"instance_norm_act: reflect pad {pad} of a "
                         f"{f * H} x {f * W} plane (at most {MAX_PAD}, below "
                         "each side; up needs one)")
    if padded is not None:
        hp, wp = f * H + 2 * pad, f * W + 2 * pad
        if (not pad or padded.shape != (V, C, hp, wp) or padded.dtype != F32
                or padded.stride()[1:] != (hp * wp, wp, 1)):
            raise ValueError("instance_norm_act: padded must be a float32 "
                             f"[{V},{C},{hp},{wp}] with dense planes")
    tensors = (x, weight, bias, add, residual, padded)
    if any(t is not None and t.device != x.device for t in tensors):
        raise ValueError("instance_norm_act: all tensors must lie on one "
                         "device")


def instance_norm_act(x, weight, bias, act=None, *, add=None, residual=None,
                      pad: int = 0, up: bool = False, unpadded: bool = True,
                      padded=None, eps: float = 1e-5) -> NormOut:
    """The fused norm: the kernel on CUDA tensors (float32, no gradient),
    the plain chain on CPU tensors. Same arguments and results as
    `instance_norm_act_plain`; `padded`, where given, receives the padded
    output. Counts `instance_norm_act.launches`."""
    if x.device.type == "cpu":
        return instance_norm_act_plain(
            x, weight, bias, act, add=add, residual=residual, pad=pad, up=up,
            unpadded=unpadded, padded=padded, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no fused instance norm for device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, bias, add, residual)):
        raise RuntimeError("instance_norm_act: the kernel has no backward")
    _check(x, weight, bias, add, residual, pad, up, padded)
    V, C, H, W = x.shape
    plan = launch_plan(H, W)
    if plan is None:
        raise ValueError(f"instance_norm_act: a {H} x {W} plane does not fit "
                         "in one block's shared memory")
    new = functools.partial(torch.empty, device=x.device, dtype=F32)
    s = None if add is None else new(x.shape)
    y = new(x.shape) if unpadded else None
    f = 2 if up else 1
    if pad and padded is None:
        padded = new((V, C, f * H + 2 * pad, f * W + 2 * pad))
    pstride = padded.stride(0) if padded is not None else 0
    ptrs = [None if t is None else t.data_ptr()
            for t in (x, add, residual, weight, bias, s, y, padded)]
    with torch.cuda.device(x.device):
        status = library().instance_norm_act_forward(
            *ptrs, pstride, V * C, C, H, W, pad, int(up), ACTS[act], eps,
            *plan,
            torch.cuda.current_stream().cuda_stream)
    build.check(status, "instance_norm_act")
    instance_norm_act.launches += 1
    return NormOut(s, y, padded)


# launches of the kernel
instance_norm_act.launches = 0
