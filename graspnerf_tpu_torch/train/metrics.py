"""Validation metrics and image dumps (graspnerf_tpu/train/metrics.py:15-67;
ref: src/nr/network/metrics.py).

psnr, ssim and depth_mae take tensors and return 0-d tensors;
visualize_image writes a side-by-side pred|gt panel like the reference's
VisualizeImage (metrics.py:86-114), through PIL where it imports and
otherwise through the port's own PNG writer (data/png.py: PIL's bytes).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..data.png import save_png


def psnr(pred, gt, max_val: float = 1.0):
    mse = torch.mean((pred - gt) ** 2)
    return (20.0 * np.log10(max_val)
            - 10.0 * torch.log10(torch.clamp(mse, min=1e-10)))


def ssim(pred, gt, max_val: float = 1.0, filter_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Gaussian-windowed SSIM on [H,W,C] images (scikit-image semantics),
    the blur symmetric-padded as in JAX."""
    r = filter_size // 2
    x = np.arange(-r, r + 1, dtype=np.float32)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    w = torch.as_tensor(w / w.sum(), device=pred.device)

    def blur(img):
        img = img.permute(2, 0, 1)[:, None]                      # C,1,H,W
        # symmetric padding (edge sample repeated) = reflect of a one-wider pad
        img = torch.cat([img[..., :r, :].flip(-2), img,
                         img[..., -r:, :].flip(-2)], -2)
        img = torch.cat([img[..., :r].flip(-1), img,
                         img[..., -r:].flip(-1)], -1)
        img = F.conv2d(img, w.flip(0).view(1, 1, -1, 1))        # along H
        img = F.conv2d(img, w.flip(0).view(1, 1, 1, -1))        # along W
        return img[:, 0].permute(1, 2, 0)

    mu_p, mu_g = blur(pred), blur(gt)
    var_p = blur(pred * pred) - mu_p ** 2
    var_g = blur(gt * gt) - mu_g ** 2
    cov = blur(pred * gt) - mu_p * mu_g
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    s = ((2 * mu_p * mu_g + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_g ** 2 + c1) * (var_p + var_g + c2))
    return torch.mean(s)


def depth_mae(pred, gt, mask=None):
    err = torch.abs(pred - gt)
    if mask is not None:
        m = mask.to(err.dtype)
        return torch.sum(err * m) / torch.clamp(torch.sum(m), min=1)
    return torch.mean(err)


def visualize_image(pred_rgb, gt_rgb, out_dir: str, step: int,
                    name: str = "val") -> str:
    """Write `<out_dir>/<step>-<name>.png`, pred | gt side by side (numpy
    or tensors, [H,W,3] in [0,1]); returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    p = np.clip(np.asarray(torch.as_tensor(pred_rgb).cpu()), 0, 1)
    g = np.clip(np.asarray(torch.as_tensor(gt_rgb).cpu()), 0, 1)
    panel = (np.concatenate([p, g], axis=1) * 255).astype(np.uint8)
    path = os.path.join(out_dir, f"{step}-{name}.png")
    save_png(path, panel)
    return path
