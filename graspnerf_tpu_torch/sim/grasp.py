"""Grasp value types + voxel<->metric conversion (graspnerf_tpu/sim/grasp.py;
ref: src/gd/grasp.py:1-31).

Frame convention (Panda hand, matching the reference simulator
ref simulation.py:377-386, 472-490):
  z-axis  = approach direction (points from the wrist through the fingers)
  y-axis  = finger closing line (Panda finger joints translate along +/-y)
  x-axis  = completes the right-handed frame (finger width direction)
TCP = midpoint between fingertip pads.
"""
from __future__ import annotations

import enum

from .transform import Rotation, Transform


class Label(enum.IntEnum):
    FAILURE = 0
    SUCCESS = 1


class Grasp:
    """A parallel-jaw grasp: TCP pose + commanded opening width [m]."""

    def __init__(self, pose: Transform, width: float):
        self.pose = pose
        self.width = float(width)

    def __iter__(self):  # (pose, width) tuple compatibility
        yield self.pose
        yield self.width

    def __repr__(self):
        return f"Grasp(t={self.pose.translation}, width={self.width:.4f})"


def to_voxel_coordinates(grasp: Grasp, voxel_size: float) -> Grasp:
    pose = Transform(grasp.pose.rotation, grasp.pose.translation / voxel_size)
    return Grasp(pose, grasp.width / voxel_size)


def from_voxel_coordinates(grasp: Grasp, voxel_size: float) -> Grasp:
    pose = Transform(grasp.pose.rotation, grasp.pose.translation * voxel_size)
    return Grasp(pose, grasp.width * voxel_size)


__all__ = ["Label", "Grasp", "to_voxel_coordinates", "from_voxel_coordinates",
           "Rotation", "Transform"]
