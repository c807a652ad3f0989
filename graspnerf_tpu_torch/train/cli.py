"""Training entry point of the port (scripts/train.py; ref: train.sh +
run_training.py:9-10).

Trains GraspNeRF end to end (renderer + grasp head) on the card, or on the
CPU with `--device cpu`. Configuration comes from a YAML file (--cfg, the
key scheme of configs/nrvgn_sdf.yaml) with command-line overrides. Without
--data-dir it trains on the synthetic scene generator
(graspnerf_tpu_torch/data/synthetic.py); with --data-dir on the vgn_syn file
contract. Scene batches come from `--workers` worker processes.
The weights start from a seeded random init.

Usage:
  python3 -m graspnerf_tpu_torch.train.cli --cfg configs/nrvgn_sdf.yaml --steps 1000
  python3 -m graspnerf_tpu_torch.train.cli --device cpu --small --steps 2 --workers 0
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

# --small: the shapes of the port's CPU checks, a step in well under a second
SMALL_SHAPE = dict(h=64, w=96, n_rays=24, n_grasps=5)
SMALL_RENDERER = {"depth_sample_num": 16, "fine_depth_sample_num": 16,
                  "volume_resolution": 8, "depth_loss_coords_num": 256}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python3 -m graspnerf_tpu_torch.train.cli",
        description="Train GraspNeRF with the PyTorch/CUDA port.")
    p.add_argument("--cfg", default=None, help="YAML config path")
    p.add_argument("--workdir", default="data/train")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--val-interval", type=int, default=None)
    p.add_argument("--save-interval", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=None,
                   help="metrics cadence (steps); 1 = per-step diagnostics")
    p.add_argument("--height", type=int, default=288)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--rays", type=int, default=None)
    p.add_argument("--small", action="store_true",
                   help="tiny shapes for smoke testing: 64 x 96 views, 24 "
                        "rays, 16 + 16 samples, an 8^3 volume, 256 depth-"
                        "loss pixels, 5 grasps")
    p.add_argument("--data-dir", default=None,
                   help="vgn_syn dataset root (reference file contract); "
                        "defaults to the synthetic generator")
    p.add_argument("--sdf-dir", default=None)
    p.add_argument("--grasp-dir", default=None)
    p.add_argument("--scenes-per-batch", type=int, default=1)
    p.add_argument("--workers", type=int, default=4,
                   help="data worker processes (0 = in this process)")
    p.add_argument("--compute-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="the model's compute dtype (parameters, Adam and "
                        "the losses stay float32)")
    p.add_argument("--device", default=None,
                   help="torch device; the card by default, 'cpu' for the "
                        "CPU")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-tensorboard", action="store_true",
                   help="no TensorBoard scalars (its import alone can take "
                        "seconds)")
    return p


def datasets(args, res: int, shape: dict):
    """(factory(seed) of the training dataset, the validation dataset).
    shape: the synthetic scenes' h, w, n_rays and, with --small, n_grasps."""
    from ..data import (DatasetFactory, SyntheticSceneDataset, VGNSynDataset,
                        discover_scenes)
    if not args.data_dir:
        factory = DatasetFactory(SyntheticSceneDataset, resolution=res,
                                 **shape)
        return factory, factory(args.seed + 777_777)
    # held-out validation scenes (ref asset.py train/val scene lists): an
    # on-disk val split when present, else the last train scene(s)
    train_scenes = discover_scenes(args.data_dir, ("pile", "packed"), "train")
    val_scenes = discover_scenes(args.data_dir, ("pile", "packed"), "val")
    if not val_scenes and len(train_scenes) > 1:
        n_hold = max(1, len(train_scenes) // 10)
        val_scenes = train_scenes[-n_hold:]
        train_scenes = train_scenes[:-n_hold]
    if not val_scenes:
        print("WARNING: no held-out val scenes (single train scene, no "
              "on-disk val split): validating on the training scene",
              file=sys.stderr)
    kw = dict(root=args.data_dir, sdf_root=args.sdf_dir,
              grasp_root=args.grasp_dir, n_rays=shape["n_rays"])
    return (DatasetFactory(VGNSynDataset, scenes=train_scenes, **kw),
            VGNSynDataset(seed=args.seed + 777_777,
                          scenes=val_scenes or train_scenes, **kw))


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)

    import torch
    from ..config import load_cfg, renderer_cfg_from, trainer_cfg_from
    from ..data import SceneLoader
    from ..models import GraspNeRF, init_parameters_, resolve_device
    from .trainer import Trainer, check_trainable

    ycfg = load_cfg(args.cfg) if args.cfg else {}
    if args.compute_dtype:
        ycfg["compute_dtype"] = args.compute_dtype
    rcfg = renderer_cfg_from(ycfg)
    try:
        check_trainable(rcfg.get("compute_dtype", "float32"))
    except NotImplementedError as e:
        p.error(str(e))
    tcfg = trainer_cfg_from(ycfg)
    if args.steps is not None:
        tcfg["total_steps"] = args.steps
    if args.val_interval is not None:
        tcfg["val_interval"] = args.val_interval
    if args.log_every is not None:
        tcfg["log_every"] = args.log_every
    shape = {"h": args.height, "w": args.width,
             "n_rays": ycfg.get("ray_num", 512)}
    if args.small:
        rcfg.update(SMALL_RENDERER)
        shape.update(SMALL_SHAPE)
    if args.rays:
        shape["n_rays"] = args.rays
    res = rcfg.get("volume_resolution", 40)
    device = resolve_device(args.device)

    factory, val_ds = datasets(args, res, shape)
    val = [val_ds.sample() for _ in range(2)]
    model = init_parameters_(GraspNeRF(rcfg),
                             torch.Generator().manual_seed(args.seed))
    with SceneLoader(factory, num_workers=args.workers,
                     scenes_per_batch=args.scenes_per_batch, seed=args.seed,
                     pin_memory=device.type == "cuda") as loader:
        Trainer(model, loader, val_batches=val, workdir=args.workdir,
                save_interval=args.save_interval, seed=args.seed,
                val_image_dir=str(Path(args.workdir) / "vis_val"),
                tensorboard=not args.no_tensorboard, device=device,
                **tcfg).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
