"""Training losses (graspnerf_tpu/train/losses.py:18-130). Each loss maps
outputs (and labels) to a dict of 0-d tensors; every key that starts with
"loss" is summed into the total, and the other keys are diagnostics."""
from __future__ import annotations

from typing import Dict

import torch

from ..ops import quat
from ..ops.interpolate import interpolate_feats


def smooth_l1(pred, target, beta: float = 1.0):
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def render_loss(outputs, weight: float = 0.01, use_fine: bool = True):
    """Ray-masked squared colour error, coarse and fine."""
    gt = outputs["pixel_colors_gt"]

    def one(pred, mask):
        err = torch.sum((pred - gt) ** 2, -1)
        m = mask.to(err.dtype)
        return weight * torch.sum(torch.sum(err * m, 1)
                                  / (torch.sum(m, 1) + 1e-3))

    out = {"loss_rgb_nr": one(outputs["pixel_colors_nr"],
                              outputs["ray_mask"])}
    if use_fine and "pixel_colors_nr_fine" in outputs:
        out["loss_rgb_nr_fine"] = one(outputs["pixel_colors_nr_fine"],
                                      outputs["ray_mask_fine"])
    return out


def _to_inv_norm_clipped(depth, depth_range):
    near = -1.0 / depth_range[:, 0:1]
    far = -1.0 / depth_range[:, 1:2]
    d = -1.0 / torch.clamp_min(depth, 1e-5)
    return torch.clamp((d - near) / (far - near), 0.0, 1.0)


def depth_loss(outputs, true_depth, depth_range, weight: float = 1.0):
    """Squared error in normalised inverse depth at the sampled pixels:
    true_depth [V,H,W,1], depth_range [V,2]; `depth_coords` and the means
    from `predict_mean_for_depth_loss`."""
    _, H, W, _ = true_depth.shape
    gt = interpolate_feats(true_depth, outputs["depth_coords"], H, W,
                           "border", True)[..., 0]
    gt = _to_inv_norm_clipped(gt, depth_range)
    out = {"loss_depth": weight * torch.mean((gt - outputs["depth_mean"]) ** 2)}
    if "depth_mean_fine" in outputs:
        out["loss_depth_fine"] = weight * torch.mean(
            (gt - outputs["depth_mean_fine"]) ** 2)
    return out


def sdf_loss(outputs, sdf_gt, sdf_weight: float = 1.0,
             eikonal_weight: float = 0.1):
    """SmoothL1 on the volume's valid voxels (sdf_gt != -1) plus the
    eikonal term. Both sides are zeroed outside the mask and the mean runs
    over all voxels, as in the JAX package (losses.py:68-70)."""
    vol = outputs["volume"]
    valid = (sdf_gt != -1.0).to(vol.dtype)
    out = {"loss_sdf": sdf_weight * torch.mean(smooth_l1(vol * valid,
                                                         sdf_gt * valid)),
           "loss_eikonal": eikonal_weight * torch.mean(
               outputs["sdf_gradient_error"]),
           "variance": torch.mean(outputs["s"])}
    out["sdf_mae"] = (torch.sum(torch.abs(vol * valid - sdf_gt * valid))
                      / torch.clamp_min(torch.sum(sdf_gt != -1.0), 1))
    return out


def vgn_loss(outputs, grasp_label, grasp_rot, grasp_width,
             weight: float = 1e-2):
    """Grasp head: quality BCE, label-masked symmetric quaternion loss and
    0.01 times the label-masked width error; grasp_label [n], grasp_rot
    [n,2,4] (xyzw), grasp_width [n] in voxels."""
    qual, rot, width = outputs["vgn_pred"]
    eps = 1e-7
    q = torch.clamp(qual, eps, 1 - eps)
    loss_qual = -(grasp_label * torch.log(q)
                  + (1 - grasp_label) * torch.log(1 - q))
    quat_err = 1.0 - torch.abs(torch.sum(rot[:, None, :] * grasp_rot, -1))
    loss_rot = grasp_label * torch.min(quat_err, -1).values
    loss_width = grasp_label * 0.01 * (width - grasp_width) ** 2
    total = loss_qual + loss_rot + loss_width

    num_pos = torch.sum(grasp_label)
    rot_err = quat.rot_error_deg_symmetric(rot, grasp_rot)
    return {
        "loss_vgn": weight * torch.mean(total),
        "vgn_total_loss": torch.mean(total),
        "vgn_qual_loss": torch.mean(loss_qual),
        "vgn_rot_loss": torch.mean(loss_rot),
        "vgn_width_loss": torch.mean(loss_width),
        "vgn_qual_acc": 100.0 * torch.mean(
            (torch.round(qual) == grasp_label).to(torch.float32)),
        "vgn_rot_err": torch.where(
            num_pos > 0, torch.sum(grasp_label * rot_err)
            / torch.clamp_min(num_pos, 1), torch.zeros_like(num_pos)),
    }


def total_loss(loss_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sum of every "loss*" entry."""
    return sum(v for k, v in loss_dict.items() if k.startswith("loss"))


def psnr(pred, gt):
    """PSNR of [0,1] colours."""
    err = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(err, 1e-10))
