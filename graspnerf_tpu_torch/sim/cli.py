"""Closed-loop sim grasping entry point of the port (scripts/sim_grasp.py;
ref: run_simgrasp.sh).

Runs the clutter-removal campaign (sim/clutter_removal.py) with the port's
GraspNeRF planner on the SimWorld: ClutterRemovalSim scenes, the
domain-randomized renderer and the ray-cast gripper on the host, the depth
fusion and the planner (through the hand-written kernels) on the card, or on
the CPU with `--device cpu`. The weights come from a checkpoint of the port
(`--ckpt`, train/checkpoint.py) or a seeded random init.
`--random-planner` runs the no-model baseline (random top-down grasps);
`--world analytic` the smoke-test world. Prints the metrics JSON; exits 1
if any round raised (its traceback is in <logdir>/errors.log).

Usage:
  python3 -m graspnerf_tpu_torch.sim.cli --rounds 5 --logdir data/simgrasp
  python3 -m graspnerf_tpu_torch.sim.cli --ckpt data/train/ckpt/best \\
      --rounds 200 --scene packed
  python3 -m graspnerf_tpu_torch.sim.cli --device cpu --small --rounds 1
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# --small: the JAX script's 16^3 volume
SMALL_RENDERER = {"volume_resolution": 16}
QUAL_THRESHOLD = 0.5


def random_planner_factory(seed: int = 0):
    """No-model baseline: random near-top-down grasps over the workspace
    (the floor any learned planner must beat)."""
    from .transform import Rotation, Transform

    rng = np.random.RandomState(seed)

    def planner(images, extrinsics, Ks, depth_range, round_idx, n_grasp):
        grasps = []
        for _ in range(4):
            # volume-local position (shifted by BBOX_MIN in the harness)
            pos = rng.uniform([0.05, 0.05, 0.055], [0.25, 0.25, 0.15])
            yaw = rng.uniform(0, 2 * np.pi)
            cy, sy = np.cos(yaw), np.sin(yaw)
            # z-axis down (approach), x/y spun by yaw
            R = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, -1.0]])
            R[:, 0] = np.cross(R[:, 1], R[:, 2])  # right-handed
            grasps.append((Transform(Rotation.from_matrix(R), pos), 0.08))
        return grasps, rng.rand(4), 0.0
    return planner


def seeded_params(renderer_cfg: dict, seed: int = 0):
    """A seeded random GraspNeRF state dict (`models.init_parameters_`),
    its width bias at 4 voxels so that random weights leave widths inside
    process()'s [1.33, 9.33] window, and so candidates."""
    import torch
    from ..models import GraspNeRF, init_parameters_
    model = init_parameters_(GraspNeRF(renderer_cfg),
                             torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    sd["vgn_net.conv_width.bias"].fill_(4.0)
    return sd


def model_planner(ckpt, small: bool, compute_dtype: str, device, seed: int):
    from ..detect.planner import GraspNeRFPlanner
    cfg = {"render_rgb": False, "use_depth_loss": False,
           "compute_dtype": compute_dtype}
    if small:
        cfg.update(SMALL_RENDERER)
    if ckpt:
        from ..train.checkpoint import load_params
        params = load_params(ckpt)
    else:
        params = seeded_params(cfg, seed)
    return GraspNeRFPlanner(params, device=device, renderer_cfg=cfg,
                            qual_threshold=QUAL_THRESHOLD)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python3 -m graspnerf_tpu_torch.sim.cli",
        description="Closed-loop clutter removal with the PyTorch/CUDA port.")
    p.add_argument("--logdir", default="data/simgrasp")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--objects", type=int, default=4)
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint of the port (train/checkpoint.py)")
    p.add_argument("--random-planner", action="store_true")
    p.add_argument("--small", action="store_true",
                   help="a 16^3 volume (give the views' size with "
                        "--height/--width)")
    p.add_argument("--scene", default="pile", choices=["pile", "packed"])
    p.add_argument("--world", default="sim", choices=["sim", "analytic"])
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default=None,
                   help="torch device; the card by default, 'cpu' to run "
                        "on the CPU")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    from ..models import resolve_device
    from . import clutter_removal
    from .world import AnalyticWorld, SimWorld

    device = resolve_device(args.device)
    if args.random_planner:
        planner = random_planner_factory(args.seed)
    else:
        planner = model_planner(args.ckpt, args.small, args.compute_dtype,
                                device, args.seed)
    rng = np.random.RandomState(args.seed)
    world = (SimWorld(args.scene, rng=rng, device=device)
             if args.world == "sim" else AnalyticWorld(rng))
    errors = os.path.join(args.logdir, "errors.log")
    before = os.path.getsize(errors) if os.path.exists(errors) else 0
    metrics = clutter_removal.run(planner, args.logdir, n_rounds=args.rounds,
                                  n_objects=args.objects, seed=args.seed,
                                  world=world, scene=args.scene,
                                  h=args.height, w=args.width, device=device)
    print(json.dumps(metrics, indent=2))
    if os.path.exists(errors) and os.path.getsize(errors) > before:
        with open(errors) as f:
            f.seek(before)
            sys.stderr.write(f.read())
        print(f"sim.cli: a round raised; see {errors}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
