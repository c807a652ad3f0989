"""SE(3) transforms on numpy (graspnerf_tpu/sim/transform.py; ref:
src/gd/utils/transform.py:5-112).

A scipy-free Rotation/Transform pair backed by the numpy functions of
ops/quat.py (xyzw quaternions, scipy-compatible conventions). The planner's
grasps (detect/postprocess.py) and the simulator share these classes.
"""
from __future__ import annotations

import numpy as np

from ..ops import quat as Q


class Rotation:
    def __init__(self, q_xyzw):
        self._q = np.asarray(q_xyzw, np.float64)
        self._q = self._q / np.linalg.norm(self._q)

    @classmethod
    def from_quat(cls, q):
        return cls(q)

    @classmethod
    def from_matrix(cls, m):
        return cls(Q.matrix_to_quat(np.asarray(m, np.float64)))

    @classmethod
    def from_rotvec(cls, v):
        v = np.asarray(v, np.float64)
        angle = np.linalg.norm(v)
        axis = v / angle if angle > 1e-12 else np.array([1.0, 0, 0])
        return cls(Q.from_axis_angle(axis, angle))

    @classmethod
    def identity(cls):
        return cls([0.0, 0.0, 0.0, 1.0])

    def as_quat(self):
        return self._q.copy()

    def as_matrix(self):
        return Q.quat_to_matrix_np(self._q)

    def apply(self, v):
        return Q.rotate_vector(self._q, np.asarray(v, np.float64))

    def inv(self):
        return Rotation(Q.quat_conjugate(self._q))

    def __mul__(self, other):
        return Rotation(Q.quat_multiply(self._q, other._q))


class Transform:
    """Rigid transform y = R x + t."""

    def __init__(self, rotation: Rotation, translation):
        self.rotation = rotation
        self.translation = np.asarray(translation, np.float64)

    @classmethod
    def identity(cls):
        return cls(Rotation.identity(), np.zeros(3))

    @classmethod
    def from_matrix(cls, m):
        m = np.asarray(m)
        return cls(Rotation.from_matrix(m[:3, :3]), m[:3, 3])

    @classmethod
    def look_at(cls, eye, center, up):
        """World→camera transform with +z forward (OpenCV), matching the
        reference's look_at (transform.py)."""
        eye, center, up = (np.asarray(a, np.float64) for a in (eye, center, up))
        fwd = center - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], 0)
        return cls(Rotation.from_matrix(R), -R @ eye)

    def as_matrix(self):
        m = np.eye(4)
        m[:3, :3] = self.rotation.as_matrix()
        m[:3, 3] = self.translation
        return m

    def apply(self, p):
        return self.rotation.apply(p) + self.translation

    def inverse(self):
        rot_inv = self.rotation.inv()
        return Transform(rot_inv, -rot_inv.apply(self.translation))

    def __mul__(self, other: "Transform"):
        return Transform(self.rotation * other.rotation,
                         self.rotation.apply(other.translation)
                         + self.translation)

    def to_list(self):
        return np.r_[self.rotation.as_quat(), self.translation].tolist()

    @classmethod
    def from_list(cls, lst):
        return cls(Rotation.from_quat(lst[:4]), lst[4:7])
