"""The training losses, the gradient of their sum with respect to every
parameter, and Adam with the finite guard, for one scene."""
from __future__ import annotations

from typing import Dict

import torch

from . import ops

LOSS_WEIGHTS = {"rgb": 0.01, "depth": 1.0, "sdf": 1.0, "eikonal": 0.1,
                "vgn": 0.01}
ADAM = {"lr": 1e-4, "b1": 0.9, "b2": 0.999, "eps": 1e-8}


def loss_terms(out, batch) -> Dict[str, torch.Tensor]:
    """Every loss term of the training forward's outputs `out`."""
    data, w = batch["data"], LOSS_WEIGHTS
    que, ref = data["que"], data["ref"]
    gt = ops.fetch(que["imgs"], que["coords"], *que["imgs"].shape[1:3],
                   border=False, align_corners=True)

    def rgb(p):
        err = torch.sum((p["pixel"] - gt) ** 2, -1)
        m = p["ray_mask"].float()
        return w["rgb"] * torch.sum(torch.sum(err * m, 1)
                                    / (torch.sum(m, 1) + 1e-3))

    true_depth = batch["true_depth"]
    _, H, W, _ = true_depth.shape
    d = ops.fetch(true_depth, out["depth_coords"], H, W, border=True,
                  align_corners=True)[..., 0]
    dr = ref["depth_range"]
    near, far = -1.0 / dr[:, 0:1], -1.0 / dr[:, 1:2]
    d = torch.clamp((-1.0 / d.clamp_min(1e-5) - near) / (far - near), 0, 1)

    vol, sdf_gt = out["volume"], batch["sdf_gt"]
    valid = (sdf_gt != -1.0).float()
    diff = torch.abs(vol * valid - sdf_gt * valid)
    smooth = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)

    qual, rot, width = out["grasp"]
    label = batch["grasp_label"]
    q = torch.clamp(qual, 1e-7, 1 - 1e-7)
    l_qual = -(label * torch.log(q) + (1 - label) * torch.log(1 - q))
    quat = 1.0 - torch.abs(torch.sum(rot[:, None] * batch["grasp_rot"], -1))
    l_rot = label * torch.min(quat, -1).values
    l_width = label * 0.01 * (width - batch["grasp_width"]) ** 2
    return {
        "loss_rgb_nr": rgb(out["coarse"]),
        "loss_rgb_nr_fine": rgb(out["fine"]),
        "loss_depth": w["depth"] * torch.mean((d - out["depth_mean"]) ** 2),
        "loss_depth_fine": w["depth"] * torch.mean(
            (d - out["depth_mean_fine"]) ** 2),
        "loss_sdf": w["sdf"] * torch.mean(smooth),
        "loss_eikonal": w["eikonal"] * out["coarse"]["eikonal"],
        "loss_vgn": w["vgn"] * torch.mean(l_qual + l_rot + l_width),
    }


def adam_step(params, grads, state: dict, step: int) -> None:
    """Adam (betas 0.9 / 0.999, eps 1e-8, lr 1e-4) in place; state holds
    each parameter's moments by name."""
    a = ADAM
    c1, c2 = 1 - a["b1"] ** step, 1 - a["b2"] ** step
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, (torch.zeros_like(p),
                                       torch.zeros_like(p)))
        m.mul_(a["b1"]).add_(g, alpha=1 - a["b1"])
        v.mul_(a["b2"]).addcmul_(g, g, value=1 - a["b2"])
        p.data.addcdiv_(m, (v.sqrt() / c2 ** 0.5).add_(a["eps"]),
                        value=-a["lr"] / c1)


def train_step(model, batch, generator, state: dict, step: int):
    """One step: the losses, every parameter's gradient (zero where the
    total does not reach it), and an Adam update unless a gradient is not
    finite. Returns (loss terms as floats, gradients by name, updated)."""
    out = model.train_forward(batch["data"], generator)
    terms = loss_terms(out, batch)
    total = sum(terms.values())
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g.detach()
             for (n, p), g in zip(params.items(), grads)}
    finite = bool(torch.isfinite(torch.cat([g.reshape(-1) for g in
                                            grads.values()])).all())
    if finite:
        adam_step(params, grads, state, step)
    values = {k: float(v.detach()) for k, v in terms.items()}
    values["total"] = float(total.detach())
    return values, grads, finite
