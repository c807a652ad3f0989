"""Rigid transforms for the planner's grasps: the port's own copy of the
parts of graspnerf_tpu/sim/transform.py and ops/quat.py that
`candidates_to_grasps` needs (xyzw quaternions, scipy conventions)."""
from __future__ import annotations

import numpy as np


class Rotation:
    def __init__(self, q_xyzw):
        q = np.asarray(q_xyzw, np.float64)
        self._q = q / np.linalg.norm(q)

    @classmethod
    def from_quat(cls, q):
        return cls(q)

    def as_quat(self):
        return self._q.copy()

    def as_matrix(self):
        x, y, z, w = self._q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


class Transform:
    """Rigid transform y = R x + t."""

    def __init__(self, rotation: Rotation, translation):
        self.rotation = rotation
        self.translation = np.asarray(translation, np.float64)

    def as_matrix(self):
        m = np.eye(4)
        m[:3, :3] = self.rotation.as_matrix()
        m[:3, 3] = self.translation
        return m
