"""Aggregate clutter-removal results across log dirs
(scripts/stat_expresult.py; ref: scripts/stat_expresult.py:12-113).

  python3 -m graspnerf_tpu_torch.sim.stats data/simgrasp [more dirs...]
"""
from __future__ import annotations

import json
import sys

import numpy as np

from .clutter_removal import compute_metrics


def aggregate(dirs) -> dict:
    """The metrics of every dir pooled: success rate weighted by grasps,
    the other rates averaged over dirs, grasps and rounds summed."""
    per_dir = [compute_metrics(d) for d in dirs]
    return {
        "success_rate": float(np.average(
            [m["success_rate"] for m in per_dir],
            weights=[max(m["n_grasps"], 1) for m in per_dir])),
        "percent_cleared": float(np.mean(
            [m["percent_cleared"] for m in per_dir])),
        "first_grasp_sr": float(np.mean(
            [m["first_grasp_sr"] for m in per_dir])),
        "planning_time": float(np.mean(
            [m["planning_time"] for m in per_dir])),
        "n_grasps": sum(m["n_grasps"] for m in per_dir),
        "n_rounds": sum(m["n_rounds"] for m in per_dir),
    }


def main(argv=None) -> int:
    dirs = (sys.argv[1:] if argv is None else argv) or ["data/simgrasp"]
    print(json.dumps(aggregate(dirs), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
