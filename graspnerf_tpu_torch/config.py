"""The flat YAML config (configs/nrvgn_sdf.yaml) -> the port's constructor
arguments: a copy of graspnerf_tpu/config.py:17-63, since importing that
module imports the JAX package.

`compute_dtype` maps as in JAX (graspnerf_tpu/config.py:39); the renderer
takes float32 or bfloat16. The port has no Pallas switch (its kernels are
chosen by `use_kernels`), so `use_pallas` is not mapped.
"""
from __future__ import annotations

from typing import Any, Dict

_RENDERER_KEYS = {
    "depth_sample_num": "depth_sample_num",
    "fine_depth_sample_num": "fine_depth_sample_num",
    "use_hierarchical_sampling": "use_hierarchical_sampling",
    "render_rgb": "render_rgb",
    "render_depth": "render_depth",
    "sample_volume": "do_sample_volume",
    "volume_resolution": "volume_resolution",
    "use_depth_loss": "use_depth_loss",
    "depth_loss_coords_num": "depth_loss_coords_num",
    "use_ray_mask": "use_ray_mask",
    "ray_mask_view_num": "ray_mask_view_num",
    "ray_mask_point_num": "ray_mask_point_num",
    "compute_dtype": "compute_dtype",
}


def load_cfg(path: str) -> Dict[str, Any]:
    import yaml   # only here: the chip machine need not have it
    with open(path) as f:
        return yaml.safe_load(f)


def renderer_cfg_from(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Config keys -> `NeuralRayRenderer` keyword arguments."""
    out = {dst: cfg[src] for src, dst in _RENDERER_KEYS.items() if src in cfg}
    agg = cfg.get("agg_net_cfg") or {}
    if "init_s" in agg:
        out["init_s"] = agg["init_s"]
    return out


def lr_cfg_from(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The `lr_cfg` part of `trainer_cfg_from`: `exp_decay_lr` keyword
    arguments, {} when the config has none."""
    lr = cfg.get("lr_cfg") or {}
    if not lr:
        return {}
    return {"lr_init": float(lr.get("lr_init", 1e-4)),
            "decay_step": int(lr.get("decay_step", 100_000)),
            "decay_rate": float(lr.get("decay_rate", 0.5))}


def trainer_cfg_from(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Config keys -> `train.Trainer` keyword arguments."""
    out = {"total_steps": cfg.get("total_step", 500_000),
           "val_interval": cfg.get("val_interval", 5000),
           "key_metric": cfg.get("key_metric_name", "loss_vgn")}
    lr = lr_cfg_from(cfg)
    if lr:
        out["lr_cfg"] = lr
    return out
