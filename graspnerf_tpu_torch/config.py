"""The flat YAML config (configs/nrvgn_sdf.yaml) -> the port's constructor
arguments: a copy of graspnerf_tpu/config.py:17-60, since importing that
module imports the JAX package.

The port computes in float32 and has no Pallas switch (its kernels are
chosen by `use_kernels`), so `compute_dtype` other than float32 is refused
and `use_pallas` is not mapped.
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
}


def load_cfg(path: str) -> Dict[str, Any]:
    import yaml   # only here: the chip machine need not have it
    with open(path) as f:
        return yaml.safe_load(f)


def renderer_cfg_from(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Config keys -> `NeuralRayRenderer` keyword arguments."""
    if cfg.get("compute_dtype", "float32") != "float32":
        raise ValueError(f"compute_dtype {cfg['compute_dtype']!r}: the port "
                         "computes in float32 only (ROADMAP Queue 1)")
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
