"""What the drivers share: the port's renderer settings from a
configuration, the kernels' build, and the reference for a configuration."""
from __future__ import annotations

import torch

from .. import reference, spec

# configuration key -> the port's NeuralRayRenderer argument
RENDERER_KEYS = {
    "depth_sample_num": "depth_sample_num",
    "fine_depth_sample_num": "fine_depth_sample_num",
    "use_hierarchical_sampling": "use_hierarchical_sampling",
    "render_rgb": "render_rgb",
    "render_depth": "render_depth",
    "sample_volume": "do_sample_volume",
    "volume_resolution": "volume_resolution",
    "use_depth_loss": "use_depth_loss",
    "depth_loss_coords_num": "depth_loss_coords_num",
    "ray_mask_view_num": "ray_mask_view_num",
    "ray_mask_point_num": "ray_mask_point_num",
    "compute_dtype": "compute_dtype",
}


def renderer_cfg(config: dict) -> dict:
    out = {dst: config[src] for src, dst in RENDERER_KEYS.items()
           if src in config}
    out["init_s"] = config["agg_net_cfg"]["init_s"]
    return out


def reference_cfg(config: dict) -> dict:
    keys = ("depth_sample_num", "fine_depth_sample_num", "volume_resolution",
            "volume_size", "depth_loss_coords_num", "ray_mask_view_num",
            "ray_mask_point_num")
    out = {k: config[k] for k in keys}
    out["init_s"] = config["agg_net_cfg"]["init_s"]
    return out


def dims(config: dict) -> dict:
    return {"views": config["num_input_views"],
            "height": config["image_height"],
            "width": config["image_width"], "channels": 32}


def build_kernels(device) -> None:
    """Build or load the port's kernels (its own cache, `_build/` in the
    checkout) before anything is timed."""
    if device.type == "cuda":
        from graspnerf_tpu_torch import build
        for name in build.KERNELS:
            build.load(name)


def reference_model(config: dict, weights, device, precision="float32"):
    """The plain reference on `device`, float32 products (TF32 off) unless
    `precision` names a control."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return reference.build(reference_cfg(config), weights, device,
                           reference.Precision(precision))


def work_kernels(names):
    return {n: spec.work(n) for n in names}
