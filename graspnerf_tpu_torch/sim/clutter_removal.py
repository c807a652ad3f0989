"""Closed-loop clutter-removal experiment (graspnerf_tpu/sim/
clutter_removal.py; ref: src/gd/experiments/clutter_removal.py:30-255 +
scripts/stat_expresult.py).

One round: reset the simulator (pile/packed scene + domain-randomized
materials/lights) → render the reference's 6 eval frames (ids 2,6,10,14,18,22
of the 24 hemisphere poses, spanning 4 elevations — run_simgrasp.sh:14) →
planner → execute best grasp with the ray-cast gripper state machine → update
survivor materials → repeat until the workspace is cleared or 2 consecutive
failures. Per-round exception isolation + render retries mirror the
reference's robustness layers (clutter_removal.py:71-78 retry-3,
run_simgrasp.sh:21-26 per-trial process isolation). Logs rounds.csv /
grasps.csv with the reference's schema and computes its metrics (grasp
success rate, percent cleared, first-grasp SR, mean planning time).

The depth fusion runs on `device` (the card unless given); the planner runs
where it was built. A round that raises is recorded in errors.log and the
campaign goes on, as in the reference: callers that must not miss a failure
check for that file (sim/cli.py exits non-zero on it).
"""
from __future__ import annotations

import csv
import os
import time
import traceback
import uuid
from typing import Callable, Optional

import numpy as np

import torch

from ..data.synthetic import hemisphere_poses, intrinsics, DEPTH_RANGE, BBOX_MIN
from ..models import resolve_device
from ..ops.tsdf import integrate_tsdf, VOLUME_SIZE
from .transform import Transform
from .world import SimWorld, Label

MAX_CONSECUTIVE_FAILURES = 2
EVAL_FRAME_IDS = (2, 6, 10, 14, 18, 22)  # ref run_simgrasp.sh:14


class Logger:
    """rounds.csv / grasps.csv with the reference's columns
    (ref clutter_removal.py:153-218)."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.rounds_path = os.path.join(logdir, "rounds.csv")
        self.grasps_path = os.path.join(logdir, "grasps.csv")
        for path, hdr in ((self.rounds_path, ["round_id", "object_count"]),
                          (self.grasps_path,
                           ["round_id", "scene_id", "qx", "qy", "qz", "qw",
                            "x", "y", "z", "width", "score", "label",
                            "integration_time", "planning_time"])):
            if not os.path.exists(path):
                with open(path, "w", newline="") as f:
                    csv.writer(f).writerow(hdr)

    def log_round(self, round_id, object_count):
        with open(self.rounds_path, "a", newline="") as f:
            csv.writer(f).writerow([round_id, object_count])

    def log_grasp(self, round_id, grasp, score, label, t_int, t_plan):
        pose, width = grasp
        q = pose.rotation.as_quat()
        t = pose.translation
        with open(self.grasps_path, "a", newline="") as f:
            csv.writer(f).writerow(
                [round_id, uuid.uuid4().hex[:8], *np.round(q, 6),
                 *np.round(t, 6), round(width, 6), round(float(score), 4),
                 int(label), round(t_int, 4), round(t_plan, 4)])


def acquire_tsdf(world, n_views: int = 6, h: int = 96, w: int = 128,
                 device=None):
    """GT/diagnostic TSDF from depth renders on the hemisphere
    (ref simulation.py:341-367, with our own fusion instead of Open3D),
    fused on `device` (the card unless given). Returns (numpy tsdf,
    seconds of the fusion)."""
    device = resolve_device(device)
    poses = hemisphere_poses()[:n_views * 4:4]
    K = intrinsics(h, w)
    depths, exts, Ks = [], [], []
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = BBOX_MIN
    for pose in poses:
        _, d = world.observe(pose, K, h, w)
        depths.append(d)
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :] = pose
        exts.append(ext @ shift)
        Ks.append(K)
    t0 = time.time()
    tsdf, wgt = integrate_tsdf(np.stack(depths), np.stack(Ks), np.stack(exts),
                               VOLUME_SIZE, 40, device=device)
    tsdf = torch.where(wgt > 0, tsdf, -1.0).cpu().numpy()
    return tsdf, time.time() - t0


def _observe_views(world, view_poses, K, h, w, retries: int = 3):
    """Render the eval views with retries (ref clutter_removal.py:71-78
    wraps Blender renders in a 3-attempt loop)."""
    last_err = None
    for _ in range(retries):
        try:
            images = []
            for pose in view_poses:
                rgb, _ = world.observe(pose, K, h, w)
                images.append(rgb)
            return np.stack(images)
        except Exception as e:  # pragma: no cover - depends on renderer
            last_err = e
    raise RuntimeError(f"render failed after {retries} attempts: {last_err}")


def run(planner: Callable, logdir: str, n_rounds: int = 5,
        n_objects: int = 4, n_views: int = 6, h: int = 96, w: int = 128,
        seed: int = 0, world=None, scene: str = "pile",
        frame_ids=EVAL_FRAME_IDS, retries: int = 3, device=None):
    """planner(images [V,h,w,3], extrinsics [V,3,4], Ks [V,3,3],
    depth_range, round_idx, n_grasp) → (grasps, scores, planning_time).

    world defaults to SimWorld(scene, device=device): ClutterRemovalSim
    scenes + the domain-randomized renderer. A world without its own
    `acquire_tsdf` is fused on `device` (the card unless given). Eval views
    are the reference's frame ids (4 elevations). A round that raises is
    logged to errors.log and skipped — one bad round never kills the
    campaign (ref run_simgrasp.sh:21-26). Returns the metrics dict."""
    rng = np.random.RandomState(seed)
    world = world or SimWorld(scene, rng=rng, device=device)
    if not hasattr(world, "acquire_tsdf"):
        device = resolve_device(device)   # raises now, not in every round
    logger = Logger(logdir)
    K = intrinsics(h, w)
    all_poses = hemisphere_poses()
    view_poses = np.stack([all_poses[i] for i in frame_ids[:n_views]])

    for round_id in range(n_rounds):
        try:
            _run_round(planner, world, logger, round_id, n_objects,
                       view_poses, K, h, w, n_views, retries, device)
        except Exception:
            # per-round isolation: record and continue the campaign
            with open(os.path.join(logdir, "errors.log"), "a") as f:
                f.write(f"round {round_id}:\n{traceback.format_exc()}\n")
    return compute_metrics(logdir)


def _run_round(planner, world, logger, round_id, n_objects, view_poses, K,
               h, w, n_views, retries, device=None):
    world.reset(n_objects)
    logger.log_round(round_id, world.num_objects)
    consecutive_failures = 0
    n_grasp = 0
    while world.num_objects > 0 and \
            consecutive_failures < MAX_CONSECUTIVE_FAILURES:
        images = _observe_views(world, view_poses, K, h, w, retries)
        Ks = np.tile(K[None], (n_views, 1, 1))
        dr = np.tile(DEPTH_RANGE[None], (n_views, 1))

        if hasattr(world, "acquire_tsdf"):
            _, t_int = world.acquire_tsdf(n_views=n_views, h=h, w=w)
        else:
            _, t_int = acquire_tsdf(world, n_views, h, w, device)
        grasps, scores, t_plan = planner(images, view_poses, Ks, dr,
                                         round_id, n_grasp)
        if len(grasps) == 0:
            break
        # execute the highest-scoring grasp (planner already permutes;
        # take argmax like the reference's first-of-sorted)
        i = int(np.argmax(scores))
        # planner grasp translations are volume-local; shift to world
        pose, width = grasps[i]
        world_pose = Transform(pose.rotation,
                               np.asarray(pose.translation) + BBOX_MIN)
        label, _ = world.execute_grasp(world_pose, width)
        logger.log_grasp(round_id, (world_pose, width), scores[i],
                         label, t_int, t_plan)
        n_grasp += 1
        consecutive_failures = (0 if label == Label.SUCCESS
                                else consecutive_failures + 1)


def compute_metrics(logdir: str):
    """Success rate / percent cleared / first-grasp SR / planning time
    (ref stat_expresult.py:88-113, clutter_removal.py:235-249)."""
    rounds, grasps = [], []
    with open(os.path.join(logdir, "rounds.csv")) as f:
        rounds = list(csv.DictReader(f))
    with open(os.path.join(logdir, "grasps.csv")) as f:
        grasps = list(csv.DictReader(f))
    if not grasps:
        return {"success_rate": 0.0, "percent_cleared": 0.0,
                "first_grasp_sr": 0.0, "planning_time": 0.0,
                "n_rounds": len(rounds), "n_grasps": 0}
    labels = np.array([int(g["label"]) for g in grasps])
    by_round: dict = {}
    for g in grasps:
        by_round.setdefault(g["round_id"], []).append(int(g["label"]))
    cleared = []
    for r in rounds:
        labs = by_round.get(r["round_id"], [])
        cleared.append(sum(labs) / max(int(r["object_count"]), 1))
    first = [labs[0] for labs in by_round.values() if labs]
    return {
        "success_rate": 100.0 * labels.mean(),
        "percent_cleared": 100.0 * float(np.mean(cleared)) if cleared else 0.0,
        "first_grasp_sr": 100.0 * float(np.mean(first)) if first else 0.0,
        "planning_time": float(np.mean([float(g["planning_time"])
                                        for g in grasps])),
        "n_rounds": len(rounds),
        "n_grasps": len(grasps),
    }
