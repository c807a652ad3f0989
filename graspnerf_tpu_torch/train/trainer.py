"""The train step (graspnerf_tpu/train/trainer.py:50-71, 100-173): the
training forward (render, volume, grasp head, depth-loss means), the summed
losses, their gradient for every parameter, and an Adam update with the
staircase-decay learning rate, skipped when a gradient is not finite.

Single-scene batch (trainer.py:18-23): {"data": the renderer's data dict
with que["imgs"] and "grasp_index" [G,3], "true_depth" [V,H,W,1], "sdf_gt"
[res,res,res], "grasp_label" [G], "grasp_rot" [G,2,4], "grasp_width" [G]}.

The step runs with grad enabled, never under `torch.inference_mode()`. It
synchronises with the card once, to test the gradients' finiteness.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from ..models.renderer import GraspNeRF, float32_on, resolve_device
from . import losses as L
from .schedule import exp_decay_lr


@dataclasses.dataclass
class TrainState:
    """The model (in train mode), its Adam optimizer, the learning-rate
    schedule, and `step`, the number of updates applied (optax's count:
    the next update uses schedule(step))."""
    model: GraspNeRF
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    step: int = 0


def compute_losses(outputs, batch) -> Dict[str, torch.Tensor]:
    ld = {}
    if "pixel_colors_nr" in outputs:
        ld.update(L.render_loss(outputs))
    if "depth_mean" in outputs and "true_depth" in batch:
        ld.update(L.depth_loss(outputs, batch["true_depth"],
                               batch["data"]["ref"]["depth_range"]))
    ld.update(L.sdf_loss(outputs, batch["sdf_gt"]))
    ld.update(L.vgn_loss(outputs, batch["grasp_label"], batch["grasp_rot"],
                         batch["grasp_width"]))
    return ld


def make_loss_fn(model: GraspNeRF) -> Callable:
    """loss_fn(batch, generator) -> (total, {every loss and diagnostic,
    and "total"}), the training forward with its draws from generator."""
    def loss_fn(batch, generator: torch.Generator):
        outputs = model(batch["data"], train=True, generator=generator)
        ld = compute_losses(outputs, batch)
        ld["total"] = L.total_loss(ld)
        return ld["total"], ld
    return loss_fn


def create_train_state(model: GraspNeRF, lr_cfg: Optional[dict] = None,
                       device=None) -> TrainState:
    """The model on `device` (the card when None, raising without one; TF32
    off there, as `load_graspnerf` does) in train mode, with Adam at
    optax's defaults (betas 0.9 / 0.999, eps 1e-8) and exp_decay_lr(**lr_cfg)."""
    device = resolve_device(device)
    float32_on(device)
    model = model.to(device).train()
    schedule = exp_decay_lr(**(lr_cfg or {}))
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, optimizer, schedule)


def gradients(state: TrainState, total: torch.Tensor) -> List[torch.Tensor]:
    """d total / d parameter for every parameter, in `parameters()` order;
    zeros for one the total does not reach."""
    params = list(state.model.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def apply_gradients(state: TrainState, grads: List[torch.Tensor]) -> bool:
    """One Adam update at schedule(state.step), unless a gradient is not
    finite: then the parameters, the optimizer's state and state.step stay
    as they were (trainer.py:142-155). Returns whether it updated."""
    finite = bool(torch.isfinite(torch.cat([g.reshape(-1) for g in grads]))
                  .all())
    if finite:
        for p, g in zip(state.model.parameters(), grads):
            p.grad = g
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
    return finite


def make_train_step(state: TrainState) -> Callable:
    """step(batch, generator) -> metrics: every key of compute_losses,
    "total" and "nonfinite_grad" (1.0 when the update was skipped), as
    detached 0-d tensors."""
    loss_fn = make_loss_fn(state.model)

    def step(batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        total, metrics = loss_fn(batch, generator)
        finite = apply_gradients(state, gradients(state, total))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["nonfinite_grad"] = total.new_tensor(0.0 if finite else 1.0)
        return metrics
    return step


def make_eval_step(state: TrainState) -> Callable:
    """eval_step(batch, generator) -> the losses and diagnostics of the eval
    forward (deterministic samples; the depth-loss pixels from generator)
    and psnr_nr, without gradients."""
    model = state.model

    @torch.no_grad()
    def eval_step(batch, generator: torch.Generator):
        outputs = model(batch["data"], train=False, generator=generator)
        ld = compute_losses(outputs, batch)
        if "pixel_colors_nr" in outputs:
            ld["psnr_nr"] = L.psnr(outputs["pixel_colors_nr"],
                                   outputs["pixel_colors_gt"])
        return ld
    return eval_step
