"""Nearest-camera view selection (ref: src/nr/utils/view_select.py:5-34).

A copy of graspnerf_tpu/data/view_select.py: importing any module of the JAX
package imports jax, which the port never does.

The generic distance-ranked selection the reference uses for non-uniform
camera rigs, alongside the azimuth-structured 'hard' mode in dataset.py
(ref train_dataset.py:195-209). Distances are between camera CENTERS
(-R^T t) in world space.
"""
from __future__ import annotations

import numpy as np


def camera_centers(poses: np.ndarray) -> np.ndarray:
    """[N,3,4] world->cam poses -> [N,3] camera centers."""
    poses = np.asarray(poses)
    return np.einsum("nji,nj->ni", -poses[:, :, :3], poses[:, :, 3])


def compute_nearest_camera_indices(ref_poses, que_poses=None):
    """Sorted ref indices by camera-center distance for every query pose:
    [qn, rfn] (ref view_select.py:5-15)."""
    ref_c = camera_centers(ref_poses)
    que_c = ref_c if que_poses is None else camera_centers(que_poses)
    dists = np.linalg.norm(ref_c[None] - que_c[:, None], axis=-1)
    return np.argsort(dists, axis=1)


def select_working_views(ref_poses, que_poses, work_num: int,
                         exclude_self: bool = False):
    """Nearest `work_num` ref views per query (ref view_select.py:17-26)."""
    ids = compute_nearest_camera_indices(ref_poses, que_poses)
    return ids[:, 1:work_num + 1] if exclude_self else ids[:, :work_num]


def select_working_views_db(database, ref_ids, que_poses, work_num: int,
                            exclude_self: bool = False):
    """Database-indexed variant (ref view_select.py:28-34)."""
    ref_ids = np.asarray(ref_ids if ref_ids is not None
                         else list(range(len(database))))
    ref_poses = np.stack([database.get_pose(i) for i in ref_ids])
    idx = select_working_views(ref_poses, np.asarray(que_poses), work_num,
                               exclude_self)
    return ref_ids[idx]
