"""Bilinear sampling at continuous pixel coords and the resizes of the CNNs
(graspnerf_tpu/ops/interpolate.py).

Feature maps are channels-last [B,H,W,C]; coords are (x, y) in full-resolution
pixel units even when sampling a downsampled map: they are normalised by the
full-res (w-1, h-1) extent and de-normalised onto the map's own size. The
arithmetic is written in the JAX package's order, op for op, so the epipolar
gather kernel (csrc/epipolar_gather.cu) can reproduce it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _denorm(coord_norm, size: int, align_corners: bool):
    """[-1,1] normalised coord -> pixel coord on a map of `size` pixels."""
    if align_corners:
        return (coord_norm + 1.0) * 0.5 * (size - 1)
    return ((coord_norm + 1.0) * size - 1.0) * 0.5


def grid_sample_2d(feats: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """feats [B,H,W,C] sampled at pixel coords px/py [B,N] -> [B,N,C].
    Integer coords hit pixel centers; out-of-range taps are clamped
    ('border') or zeroed ('zeros')."""
    B, H, W, C = feats.shape
    flat = feats.reshape(B, H * W, C)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(xi, yi):
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        if padding_mode == "zeros":
            ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            v = v * ok[..., None].to(v.dtype)
        return v

    top = tap(x0i, y0i) * (1 - wx) + tap(x0i + 1, y0i) * wx
    bot = tap(x0i, y0i + 1) * (1 - wx) + tap(x0i + 1, y0i + 1) * wx
    return top * (1 - wy) + bot * wy


def interpolate_feats(feats: torch.Tensor, points: torch.Tensor, h=None,
                      w=None, padding_mode: str = "zeros",
                      align_corners: bool = False) -> torch.Tensor:
    """feats [B,fh,fw,C], points [B,N,2] (x,y in h x w units) -> [B,N,C]."""
    B, fh, fw, C = feats.shape
    if h is None and w is None:
        h, w = fh, fw
    x_norm = points[..., 0] / (w - 1) * 2 - 1
    y_norm = points[..., 1] / (h - 1) * 2 - 1
    px = _denorm(x_norm, fw, align_corners)
    py = _denorm(y_norm, fh, align_corners)
    return grid_sample_2d(feats, px, py, padding_mode)


def interpolate_feature_map(feats: torch.Tensor, points: torch.Tensor,
                            mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Border-clamped fetch times the validity mask: feats [B,fh,fw,C],
    points [B,N,2], mask [B,N] -> [B,N,C]. align_corners only when the map
    is full-res."""
    B, fh, fw, C = feats.shape
    out = interpolate_feats(feats, points, h, w, "border", fh == h and fw == w)
    return out * mask[..., None].to(out.dtype)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True. x [B,C,H,W] (channels-first,
    the layout of the port's CNNs)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def resize_nearest_3d(x: torch.Tensor, out_d: int, out_h: int,
                      out_w: int) -> torch.Tensor:
    """Nearest volumetric resize with source index floor(i * in / out).
    x [..., D, H, W] (channels-first, the layout of the grasp head)."""
    for dim, n_out in zip((-3, -2, -1), (out_d, out_h, out_w)):
        n_in = x.shape[dim]
        idx = [math.floor(i * (n_in / n_out)) for i in range(n_out)]
        x = x.index_select(dim, torch.tensor(idx, device=x.device))
    return x
