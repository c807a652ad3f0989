"""Offline dataset writer (scripts/generate_data.py; ref: data_generator/ and
the role of run_pile_rand.sh).

Renders scenes to the vgn_syn file contract that `data.VGNSynDataset` (and
the reference's own loader) reads: rgb/%04d.png, depth/%04d.exr and
mask/%04d.exr (data/exr.py), camera_pose.npy, the GT TSDF as
sdf/<id>.npz in [0, 1] and grasps.csv in the reference's i, j, k
voxel-index schema. The files are the JAX script's, byte for byte but for
the npz's zip timestamps: the same draws in the same order, the PNGs
written as PIL writes them (data/png.py), the TSDF fused by the port
(ops/tsdf.py) on `device`, the card by default.

Two scene sources:
  * procedural primitives (default): `data.synthetic.Scene` with the
    geometric heuristic labels, or, with --executed-labels, a
    `sim.ClutterRemovalSim` scene whose grasps are labelled by executing
    candidates in it;
  * --mesh-pose-dir DIR: reference-format `mesh_pose_list` descriptors (ref
    src/gd/simulation.py:85-96,158-271) replayed through
    `ClutterRemovalSim.reset_from_mesh_pose_list`, rendered with the
    domain-randomizing tracer (ref rd/render.py) and labelled by executing
    candidates: the GIGA labelling the reference's grasps.csv files come
    from (ref src/nr/dataset/database.py:278-294).

  python3 -m graspnerf_tpu_torch.data.generate out_root --scenes 10
  python3 -m graspnerf_tpu_torch.data.generate out_root --mesh-pose-dir \\
      descs/ --asset-root assets/ --scene-type pile
  python3 -m graspnerf_tpu_torch.data.generate out_root --device cpu ...
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

VOXEL = 0.3 / 40


def executed_grasp_labels(sim, tsdf, rng, n_grasps, voxel, bbox_min):
    """GIGA-style labels: candidate centres on the observed TSDF surface
    band, the approach in a ~30 deg cone about straight down with a random
    yaw, each candidate executed in the (unmodified) sim; label = physical
    success, width = the measured closing width in voxels."""
    from ..sim.grasp import Label
    from ..sim.transform import Rotation, Transform

    res = tsdf.shape[0]
    near = np.argwhere((np.abs(tsdf) < 0.3) & (tsdf != -1.0))
    if len(near) == 0:
        near = np.stack(np.unravel_index(
            rng.randint(0, res ** 3, 64), tsdf.shape), -1)
    flip = np.diag([1.0, -1.0, -1.0])  # gripper z -> world -z
    idx, labels, quats, widths = [], [], [], []
    for _ in range(n_grasps):
        v = near[rng.randint(0, len(near))]
        pos = (v.astype(np.float64) + 0.5) * voxel + bbox_min  # world
        yaw = rng.uniform(0, 2 * np.pi)
        tilt, taz = rng.uniform(0, np.pi / 6), rng.uniform(0, 2 * np.pi)
        Rm = (Rotation.from_rotvec(
                  tilt * np.array([np.cos(taz), np.sin(taz), 0.0]))
              .as_matrix() @ flip
              @ Rotation.from_rotvec([0, 0, yaw]).as_matrix())
        rot = Rotation.from_matrix(Rm)
        (label, width), _ = sim.execute_grasp(
            (Transform(rot, pos), sim.gripper.max_opening_width),
            remove=False)
        idx.append(v)
        labels.append(float(label == Label.SUCCESS))
        quats.append(rot.as_quat())
        widths.append(width / voxel)
    return (np.asarray(idx, np.int32), np.asarray(labels, np.float32),
            np.asarray(quats, np.float32), np.asarray(widths, np.float32))


def camera_intrinsics(height: int, width: int) -> np.ndarray:
    """The reference's intrinsics at scale 0.8 of 1280 x 720 / 2 (vgn_syn),
    scaled to height x width, the principal point at the centre."""
    K = np.array([[892.62, 0, 639.5], [0, 892.62, 359.5], [0, 0, 1]],
                 np.float32)
    K = K * np.array([[width / 1280], [height / 720], [1]], np.float32)
    K[0, 2] = width / 2 - 0.5
    K[1, 2] = height / 2 - 0.5
    return K


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python3 -m graspnerf_tpu_torch.data.generate",
        description="Write a vgn_syn dataset with the PyTorch/CUDA port.")
    p.add_argument("root")
    p.add_argument("--scenes", type=int, default=4)
    p.add_argument("--scene-type", default="pile")
    p.add_argument("--split", default="train")
    p.add_argument("--height", type=int, default=288)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--objects", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh-pose-dir", default=None,
                   help="directory of reference mesh_pose_list descriptors "
                        "to replay instead of procedural scenes")
    p.add_argument("--asset-root", default="",
                   help="root for relative URDF paths in descriptors")
    p.add_argument("--grasp-candidates", type=int, default=40,
                   help="executed grasp candidates per simulated scene")
    p.add_argument("--executed-labels", action="store_true",
                   help="procedural scenes: build them in ClutterRemovalSim "
                        "and label grasps by physical execution (like the "
                        "descriptor-replay path) instead of the geometric "
                        "heuristic")
    p.add_argument("--device", default=None,
                   help="torch device of the TSDF fusion; the card by "
                        "default, 'cpu' for the CPU")
    return p


def scene_jobs(args) -> List[tuple]:
    """[(scene id, descriptor path or None)] in the order they are written."""
    if args.mesh_pose_dir:
        descs = sorted(p for p in Path(args.mesh_pose_dir).iterdir()
                       if p.suffix in (".npy", ".npz"))
        if not descs:
            raise FileNotFoundError(f"no descriptors in {args.mesh_pose_dir}")
        return [(d.stem, d) for d in descs]
    return [(f"scene_{args.seed:02d}_{s:04d}", None)
            for s in range(args.scenes)]


def write_scene(args, s: int, sid: str, desc, rng, poses, K,
                device) -> Dict[str, float]:
    """Render, fuse, label and write scene `s` (`sid`, its descriptor or
    None) under args.root, drawing from `rng` as the JAX script does.
    Returns its seconds by part -- scene (a simulated scene's build and
    settling, host), render (host), tsdf (the fusion on `device`, its copy
    back included), labels (host), write (the files) -- and its object and
    label counts."""
    from ..ops.tsdf import VOLUME_SIZE, integrate_tsdf
    from .database import BLENDER2OPENCV
    from .exr import write_exr
    from .png import write_png
    from .synthetic import BBOX_MIN, Scene, SyntheticSceneDataset

    root = Path(args.root)
    sdir = root / args.scene_type / args.split / sid
    for sub in ("rgb", "depth", "mask"):
        (sdir / sub).mkdir(parents=True, exist_ok=True)
    clock = {"scene": 0.0, "render": 0.0, "tsdf": 0.0, "labels": 0.0,
             "write": 0.0}

    def timed(part, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        clock[part] += time.perf_counter() - t0
        return out

    if desc is None and not args.executed_labels:
        scene = Scene(rng, args.objects)
        sim = None

        def render(pose):
            return scene.render(pose, K, args.height, args.width)
    else:
        # a simulated scene (descriptor replay or procedural sim.reset):
        # the labels come from executing candidates in this same world
        from ..sim.render import DomainRandomizer
        from ..sim.simulation import ClutterRemovalSim
        sim = ClutterRemovalSim(args.scene_type,
                                rng=np.random.RandomState(args.seed + s),
                                device=device)
        if desc is None:
            timed("scene", sim.reset, args.objects)
        else:
            timed("scene", sim.reset_from_mesh_pose_list, str(desc),
                  args.asset_root)
        randomizer = DomainRandomizer(np.random.RandomState(args.seed + s))
        randomizer.init_scene(sim.scene)

        def render(pose):
            return sim.observe(pose, K, args.height, args.width, randomizer)

    cam_world, depths, exts = [], [], []
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = BBOX_MIN
    for i, pose in enumerate(poses):
        rgb, depth, fg = timed("render", render, pose)
        t0 = time.perf_counter()
        write_png(str(sdir / "rgb" / ("%04d.png" % i)),
                  (rgb * 255).astype(np.uint8))
        # the reference's byte contract: depth and mask as EXR
        # (ref dataset/database.py:129-198)
        write_exr(str(sdir / "depth" / ("%04d.exr" % i)),
                  depth.astype(np.float32))
        write_exr(str(sdir / "mask" / ("%04d.exr" % i)),
                  fg.astype(np.float32))
        clock["write"] += time.perf_counter() - t0
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :] = pose
        # cam -> world in Blender axes, so that the loader's inverse matches
        cam_world.append(np.linalg.inv(ext) @ np.linalg.inv(BLENDER2OPENCV))
        depths.append(depth)
        exts.append(ext @ shift)
    timed("write", np.save, sdir / "camera_pose.npy", np.stack(cam_world))

    def fuse():
        tsdf, wgt = integrate_tsdf(np.stack(depths), np.stack([K] * len(poses)),
                                   np.stack(exts), VOLUME_SIZE, 40, device)
        return np.where(wgt.cpu().numpy() > 0, tsdf.cpu().numpy(), -1.0)
    tsdf = timed("tsdf", fuse)
    # stored in [0, 1] like the reference's GT npz (database.py:207-209)
    timed("write", lambda: np.savez_compressed(
        root / "sdf" / f"{sid}.npz",
        grid=((tsdf + 1.0) / 2.0)[None].astype(np.float32)))

    if sim is not None:
        idx, label, q1, width_vox = timed(
            "labels", executed_grasp_labels, sim, tsdf.astype(np.float32),
            rng, args.grasp_candidates, VOXEL, BBOX_MIN)
        rot = q1[:, None]  # the csv stores one quaternion; the loader adds
                           # the symmetric one
    else:
        ds = SyntheticSceneDataset(seed=args.seed + s)
        idx, label, rot, width_vox = timed(
            "labels", ds._grasp_labels, tsdf.astype(np.float32), rng)

    def write_csv():
        # the reference's grasps.csv schema: voxel-index columns i, j, k and
        # the width in voxels, read back verbatim by the loader (ref
        # database.py:278-294)
        with open(root / "grasps" / f"{sid}.csv", "w") as f:
            f.write("scene_id,qx,qy,qz,qw,i,j,k,width,label\n")
            for j in range(len(label)):
                gi, gj, gk = idx[j].astype(np.int64)
                qx, qy, qz, qw = rot[j, 0]
                f.write(f"{sid},{qx},{qy},{qz},{qw},{gi},{gj},{gk},"
                        f"{width_vox[j]},{int(label[j])}\n")
    timed("write", write_csv)
    n_objects = len(sim.scene) if sim is not None else args.objects
    print(f"[generate] {sid}: {n_objects} objects, {int(label.sum())} "
          f"positive grasps")
    return {**clock, "objects": n_objects, "grasps": len(label),
            "positive": int(label.sum())}


def generate(argv=None) -> List[Dict[str, float]]:
    """Write the dataset that the command line `argv` describes; returns
    each scene's `write_scene` record."""
    from ..models import resolve_device
    from .synthetic import hemisphere_poses

    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.RandomState(args.seed)
    poses = hemisphere_poses()
    K = camera_intrinsics(args.height, args.width)
    root = Path(args.root)
    for d in (root / args.scene_type / args.split, root / "sdf",
              root / "grasps"):
        d.mkdir(parents=True, exist_ok=True)
    return [write_scene(args, s, sid, desc, rng, poses, K, device)
            for s, (sid, desc) in enumerate(scene_jobs(args))]


def main(argv=None) -> int:
    generate(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
