"""Cells cut to a size the CPU runs in seconds: the registered cell, and
the two cells whose files are kept for a later benchmark change (PERF.md
§7), built from their files."""
import os

from bench_port import spec

TINY_CONFIG = {"image_height": 64, "image_width": 96, "volume_resolution": 8,
               "depth_sample_num": 16, "fine_depth_sample_num": 16,
               "depth_loss_coords_num": 256}
TINY_TRAFFIC = {"scenes": 4, "warmup_calls": 2, "trace_calls": 2,
                "threshold_candidates": 3, "rays": 24, "grasps": 5,
                "warmup_steps": 1, "trace_steps": 2}
# a seed whose tiny planning scenes leave candidates
SEED = 123456789012
# cells with files but no BENCHMARK.json entry: (configuration, traffic)
UNREGISTERED = {"plan-bf16": ("graspnerf-bf16", "plan_closed_loop"),
                "train-fp32": ("graspnerf-fp32", "train_steps")}


def full_cell(name: str, root=None):
    if name not in UNREGISTERED:
        return spec.cell(name, **({"root": root} if root else {}))
    config, traffic = UNREGISTERED[name]
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    return spec.make_cell(name, os.path.join(spec.HERE, "configs",
                                             config + ".json"),
                          traffic, 1, bench)


def tiny_cell(name: str, root=None):
    cell = full_cell(name, root)
    cell.config.update(TINY_CONFIG)
    cell.traffic.update({k: v for k, v in TINY_TRAFFIC.items()
                         if k in cell.traffic})
    return cell
