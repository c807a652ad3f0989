"""The seeded weights, one state dict under the port's keys, made on the
device in one draw: lecun-normal matrices and kernels (std 1/sqrt(fan
in)), zero biases, unit norm scales, the NeuS variance at its initial
value. Two choices make random weights exercise the whole planning call:
the SDF output kernels are scaled by 0.1, so that the SDF does not sit on
its clip, and the grasp width's bias is 4 voxels, inside the post-
processing's [1.33, 9.33] window, so that candidates survive it."""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.model import GraspNeRF

SDF_SCALE = 0.1
WIDTH_BIAS = 4.0
SDF_KERNELS = ("nr_net.agg_net.agg_impl.out_geometry_fc.1.weight",
               "nr_net.fine_agg_net.agg_impl.out_geometry_fc.1.weight")


def seeded(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in GraspNeRF(cfg).state_dict().items()}
    mats = [k for k, s in shapes.items() if len(s) >= 2]
    total = sum(math.prod(shapes[k]) for k in mats)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if len(s) >= 2:
            n = math.prod(s)
            out[k] = flat[at:at + n].view(s) / math.sqrt(math.prod(s[1:]))
            at += n
        elif k.endswith("variance"):
            out[k] = torch.full(s, cfg["init_s"], device=device)
        elif k.endswith("bias"):
            out[k] = torch.zeros(s, device=device)
        else:
            out[k] = torch.ones(s, device=device)
    for k in SDF_KERNELS:
        out[k] = out[k] * SDF_SCALE
    out["vgn_net.conv_width.bias"] = torch.full_like(
        out["vgn_net.conv_width.bias"], WIDTH_BIAS)
    return out
