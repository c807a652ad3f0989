"""Training entry point of the port (scripts/train.py; ref: train.sh +
run_training.py:9-10).

Trains GraspNeRF end to end (renderer + grasp head) on the card, or on the
CPU with `--device cpu`. Configuration comes from a YAML file (--cfg, the
key scheme of configs/nrvgn_sdf.yaml) with command-line overrides. Without
--data-dir it trains on the synthetic scene generator
(graspnerf_tpu_torch/data/synthetic.py); with --data-dir on the vgn_syn file
contract. Scene batches come from `--workers` worker processes.
The weights start from a seeded random init.

With `--mesh DATA,SPACE` it trains on a (data, space) mesh of DATA x SPACE
ranks (scripts/train.py --mesh): the command starts one process a rank on
this host and waits for them all, and stops them all when one fails. The
first rank of each scene group loads the group's S / DATA scenes and sends
them to the group's other ranks; the ranks of a group split its rays and
volume columns.

Usage:
  python3 -m graspnerf_tpu_torch.train.cli --cfg configs/nrvgn_sdf.yaml --steps 1000
  python3 -m graspnerf_tpu_torch.train.cli --device cpu --small --steps 2 --workers 0
  python3 -m graspnerf_tpu_torch.train.cli --mesh 1,2 --dist-backend gloo --steps 10
"""
from __future__ import annotations

import argparse
import contextlib
import os
import socket
import subprocess
import sys
import time
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
    p.add_argument("--scenes-per-batch", type=int, default=1,
                   help="scenes a step over the whole mesh")
    p.add_argument("--mesh", default=None,
                   help="DATA,SPACE: train on a mesh of DATA x SPACE ranks, "
                        "scenes on DATA, rays and volume columns on SPACE")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="NCCL on cards (one a rank), gloo on the CPU; by "
                        "default as the device. NCCL refuses two ranks on "
                        "one card: use gloo there")
    # set by the launcher on the ranks it starts
    p.add_argument("--dist-url", default=None, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
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


def free_port() -> int:
    """A TCP port free on this host now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_shape(p: argparse.ArgumentParser, args) -> tuple:
    try:
        n_data, n_space = (int(x) for x in args.mesh.split(","))
    except ValueError:
        p.error(f"--mesh {args.mesh!r}: expected DATA,SPACE")
    if n_data < 1 or n_space < 1:
        p.error(f"--mesh {args.mesh}: sizes must be positive")
    if args.scenes_per_batch % n_data != 0:
        p.error("--scenes-per-batch must be a multiple of the data-axis "
                f"size ({n_data})")
    return n_data, n_space


def launch(cmd, world_size: int) -> int:
    """Run `cmd --dist-url URL --rank r` for ranks 0..world_size-1 on this
    host, with a fresh local address and an equal share of the host's cores
    for each rank's threads (unless OMP_NUM_THREADS says otherwise), and
    wait for them all. When a rank fails, stop the others. Returns the first
    failing rank's exit code, or 0."""
    cmd = [*cmd, "--dist-url", f"tcp://127.0.0.1:{free_port()}"]
    # the package's checkout on the ranks' path, wherever they start
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    env.setdefault("OMP_NUM_THREADS", str(max(
        1, len(os.sched_getaffinity(0)) // world_size)))
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env)
             for r in range(world_size)]
    try:
        while True:
            codes = [q.poll() for q in procs]
            failed = [c for c in codes if c]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.1)
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
            q.wait()


def main(argv=None) -> int:
    p = parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    n_data = n_space = 1
    if args.mesh:
        n_data, n_space = mesh_shape(p, args)
        if args.rank is None and n_data * n_space > 1:
            return launch([sys.executable, "-m",
                           "graspnerf_tpu_torch.train.cli", *argv],
                          n_data * n_space)
    elif args.dist_url or args.rank is not None:
        p.error("--dist-url and --rank need --mesh")

    import torch
    from ..config import load_cfg, renderer_cfg_from, trainer_cfg_from
    from ..data import SceneLoader
    from ..models import GraspNeRF, init_parameters_, resolve_device
    from ..parallel import initialize, make_mesh, shutdown
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

    mesh, seed = None, args.seed
    if args.mesh:
        rank = args.rank or 0
        if device.type == "cuda" and args.dist_backend != "gloo":
            # NCCL: a card a rank
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        initialize(args.dist_url or f"tcp://127.0.0.1:{free_port()}",
                   n_data * n_space, rank, args.dist_backend, device)
        mesh = make_mesh(n_data, n_space)
        # a data rank's own scenes, loaded by its scene group's first rank
        # alone (the Trainer sends them to the others)
        seed = args.seed + 1_000_003 * mesh.data_index
    try:
        model = init_parameters_(GraspNeRF(rcfg),
                                 torch.Generator().manual_seed(args.seed))
        val, loader = None, contextlib.nullcontext()
        if mesh is None or mesh.space_index == 0:
            factory, val_ds = datasets(args, res, shape)
            val = [val_ds.sample() for _ in range(2)]
            loader = SceneLoader(
                factory, num_workers=args.workers,
                scenes_per_batch=args.scenes_per_batch // n_data, seed=seed,
                pin_memory=device.type == "cuda")
        with loader as batches:
            Trainer(model, batches, val_batches=val, workdir=args.workdir,
                    save_interval=args.save_interval, seed=args.seed,
                    val_image_dir=str(Path(args.workdir) / "vis_val"),
                    tensorboard=not args.no_tensorboard, device=device,
                    mesh=mesh, **tcfg).run()
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
