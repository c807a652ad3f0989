"""Experiment IO helpers (graspnerf_tpu/sim/io.py; ref: src/gd/io.py:12-106).

csv/json/npz readers and writers for experiment setups, rounds, grasps and
scene descriptors, matching the reference's schemas so logs are
interchangeable.
"""
from __future__ import annotations

import csv
import json
import os
import uuid
from typing import Dict, List

import numpy as np

from .transform import Transform, Rotation


def write_setup(logdir: str, sim_gui: bool, rtf: float, max_opening_width: float,
                finger_depth: float):
    os.makedirs(logdir, exist_ok=True)
    data = {"sim_gui": sim_gui, "rtf": rtf,
            "max_opening_width": max_opening_width,
            "finger_depth": finger_depth}
    with open(os.path.join(logdir, "setup.json"), "w") as f:
        json.dump(data, f, indent=2)


def read_setup(logdir: str) -> Dict:
    with open(os.path.join(logdir, "setup.json")) as f:
        return json.load(f)


def _append_csv(path: str, header: List[str], row: List):
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(header)
        w.writerow(row)


def append_round(logdir: str, round_id: int, object_count: int):
    _append_csv(os.path.join(logdir, "rounds.csv"),
                ["round_id", "object_count"], [round_id, object_count])


def append_grasp(logdir: str, round_id: int, scene_id: str, grasp, score,
                 label, integration_time: float, planning_time: float):
    pose, width = grasp
    q = pose.rotation.as_quat()
    t = pose.translation
    _append_csv(os.path.join(logdir, "grasps.csv"),
                ["round_id", "scene_id", "qx", "qy", "qz", "qw", "x", "y",
                 "z", "width", "score", "label", "integration_time",
                 "planning_time"],
                [round_id, scene_id, *q, *t, width, score, int(label),
                 integration_time, planning_time])


def read_grasps(logdir: str):
    """grasps.csv → list of dicts with a reconstructed Transform."""
    out = []
    with open(os.path.join(logdir, "grasps.csv")) as f:
        for r in csv.DictReader(f):
            pose = Transform(Rotation.from_quat(
                [float(r["qx"]), float(r["qy"]), float(r["qz"]),
                 float(r["qw"])]),
                [float(r["x"]), float(r["y"]), float(r["z"])])
            out.append({**r, "pose": pose, "width": float(r["width"]),
                        "label": int(r["label"])})
    return out


def write_scene(scene_dir: str, mesh_pose_list) -> str:
    """Scene descriptor npz: list of (mesh_path, scale, pose 4x4)
    (ref io.py write_point_cloud/scene analogs)."""
    os.makedirs(scene_dir, exist_ok=True)
    scene_id = uuid.uuid4().hex
    paths = [m[0] for m in mesh_pose_list]
    scales = np.asarray([m[1] for m in mesh_pose_list], np.float32)
    poses = np.stack([np.asarray(m[2], np.float32) for m in mesh_pose_list])
    np.savez_compressed(os.path.join(scene_dir, scene_id + ".npz"),
                        paths=paths, scales=scales, poses=poses)
    return scene_id


def read_scene(scene_dir: str, scene_id: str):
    d = np.load(os.path.join(scene_dir, scene_id + ".npz"), allow_pickle=True)
    return [(str(p), float(s), m) for p, s, m in
            zip(d["paths"], d["scales"], d["poses"])]
