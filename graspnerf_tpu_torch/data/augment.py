"""Dataset augmentations with reference parity (channels-last layouts).

A copy of graspnerf_tpu/data/augment.py: importing any module of the JAX
package imports jax, which the port never does.

Each function reproduces the corresponding reference routine exactly —
including the order random numbers are consumed in, so seeding numpy the same
way yields bit-identical outputs (tests/test_torch_data.py holds this copy
to the JAX package's):

  get_ref_que_ids          ref src/nr/dataset/train_dataset.py:204-209
  random_change_depth_range ref train_dataset.py:271-279 (non-gso branch)
  consistent_depth_range   ref train_dataset.py:320-334
  add_depth_offset         ref train_dataset.py:29-42
  random_crop / random_flip ref src/nr/utils/imgs_info.py:6-58
  pad_imgs_to_interval     ref imgs_info.py:60-75

Live-config notes (configs/nrvgn_sdf.yaml + train_dataset defaults): for the
vgn dataset the active pieces are view selection, the 5% depth-range aug,
margin-style consistent depth range, and reflect-pad to /32. Crop/flip and
the patch depth offsets exist in the reference but only fire for other
dataset families; they are provided here for completeness.

Layout: images are [V, H, W, C] float (channels-last); the
reference is NCHW — the tests transpose when comparing.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


# --------------------------------------------------------------------- views
def get_ref_que_ids(rng=np.random, total_views: int = 24, n_views: int = 6
                    ) -> Tuple[list, int]:
    """6 equally-spaced reference views anchored at a random target + a query
    view offset 1..(interval-1) from one of them (ref :204-209, called with a
    random target for training at :226)."""
    target = rng.randint(0, total_views)
    interval = total_views // n_views
    res = [(target + i) % total_views for i in range(0, total_views, interval)]
    que = (rng.choice(res) + rng.randint(1, interval)) % total_views
    return res, int(que)


# --------------------------------------------------------------- depth range
def random_change_depth_range(depth_range: np.ndarray, rng=np.random,
                              prob: float = 0.05, range_min: float = 0.95,
                              range_max: float = 1.05) -> np.ndarray:
    """Shrink near / extend far with probability `prob` (ref :271-279,
    defaults aug_depth_range_prob/min/max from train_dataset.py:22-24)."""
    out = depth_range.copy()
    if rng.random() < prob:
        out[:, 0] *= rng.uniform(range_min, 1.0)
        out[:, 1] *= rng.uniform(1.0, range_max)
    return out


def consistent_depth_range(ref_depth_range: np.ndarray,
                           que_depth_range: np.ndarray,
                           use_min_max: bool = False
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Equalize the inverse-depth parameterization across views (ref
    :320-334). use_min_max=False is the live default (use_consistent_min_max
    False): every view gets the max range length, centered by margin, with
    near floored at half its original value."""
    dr = np.concatenate([ref_depth_range, que_depth_range], 0).copy()
    if use_min_max:
        dr[:, 0] = np.min(dr)
        dr[:, 1] = np.max(dr)
    else:
        length = dr[:, 1] - dr[:, 0]
        max_len = np.max(length)
        margin = (max_len - length) / 2
        near = dr[:, 0] - margin
        near = np.max(np.stack([near, dr[:, 0] * 0.5], -1), 1)
        dr[:, 0] = near
        dr[:, 1] = near + max_len
    return dr[:-1], dr[-1:]


# --------------------------------------------------------------- depth noise
def add_depth_offset(depth: np.ndarray, mask: np.ndarray, region_min: float,
                     region_max: float, offset_min: float, offset_max: float,
                     noise_ratio: float, depth_length: float,
                     rng=np.random) -> None:
    """In-place rectangular-patch depth offset around a random foreground
    pixel (ref :29-42): a global ± offset plus per-pixel jitter, both scaled
    by the scene depth length. depth/mask are [H, W]."""
    coords = np.stack(np.nonzero(mask), -1)[:, (1, 0)]  # (x, y)
    length = np.max(coords, 0) - np.min(coords, 0)
    center = coords[rng.randint(0, coords.shape[0])]
    lx, ly = rng.uniform(region_min, region_max, 2) * length
    diff = coords - center[None, :]
    sel = (np.abs(diff[:, 0]) < lx) & (np.abs(diff[:, 1]) < ly)
    masked = coords[sel]
    global_offset = rng.uniform(offset_min, offset_max) * depth_length
    if rng.random() < 0.5:
        global_offset = -global_offset
    local = rng.uniform(-noise_ratio, noise_ratio,
                        masked.shape[0]) * depth_length + global_offset
    depth[masked[:, 1], masked[:, 0]] += local


# ---------------------------------------------------------------- crop/flip
def random_crop(imgs_info: Dict[str, np.ndarray], target_size,
                rng=np.random) -> Dict[str, np.ndarray]:
    """Center-jittered crop of imgs/depth/masks with K principal-point shift
    (ref imgs_info.py:6-36). imgs_info arrays are [V, H, W, C]; 'Ks' [V,3,3]
    is adjusted in a copy."""
    imgs = imgs_info["imgs"]
    _, h, w = imgs.shape[:3]
    out_h, out_w = target_size
    if out_w >= w or out_h >= h:
        return imgs_info
    center_h = rng.randint(low=out_h // 2 + 1, high=h - out_h // 2 - 1)
    center_w = rng.randint(low=out_w // 2 + 1, high=w - out_w // 2 - 1)
    h0 = center_h - out_h // 2
    w0 = center_w - out_w // 2

    def crop(x):
        return x[:, h0:h0 + out_h, w0:w0 + out_w]

    out = dict(imgs_info)
    for k in ("imgs", "depth", "true_depth", "masks"):
        if k in out and out[k] is not None:
            out[k] = crop(out[k])
    Ks = out["Ks"].copy()
    Ks[:, 0, 2] -= w0
    Ks[:, 1, 2] -= h0
    out["Ks"] = Ks
    return out


def random_flip(imgs_info: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Horizontal flip with the K x-axis negation (ref imgs_info.py:38-58):
    Ks[:,0,:] *= -1 then Ks[:,0,2] += w - 1, which maps pixel x -> w-1-x."""
    out = dict(imgs_info)
    for k in ("imgs", "depth", "true_depth", "masks"):
        if k in out and out[k] is not None:
            out[k] = np.ascontiguousarray(out[k][:, :, ::-1])
    Ks = out["Ks"].copy()
    Ks[:, 0, :] *= -1
    w = out["imgs"].shape[2]
    Ks[:, 0, 2] += w - 1
    out["Ks"] = Ks
    return out


# ---------------------------------------------------------------------- pad
def pad_imgs_to_interval(imgs_info: Dict[str, np.ndarray],
                         pad_interval: int = 32) -> Dict[str, np.ndarray]:
    """Reflect-pad H/W up to a multiple of pad_interval (ref imgs_info.py:
    60-75; live ref_pad_interval=32, yaml). End-padding leaves K unchanged."""
    if pad_interval <= 0:
        return imgs_info
    imgs = imgs_info["imgs"]
    h, w = imgs.shape[1:3]
    ph = (pad_interval - (h % pad_interval)) % pad_interval
    pw = (pad_interval - (w % pad_interval)) % pad_interval
    if ph == 0 and pw == 0:
        return imgs_info
    out = dict(imgs_info)
    for k in ("imgs", "depth", "true_depth", "masks"):
        if k in out and out[k] is not None:
            x = out[k]
            pad = [(0, 0), (0, ph), (0, pw)] + [(0, 0)] * (x.ndim - 3)
            out[k] = np.pad(x, pad, "reflect")
    return out
