"""Simulation worlds for closed-loop grasp evaluation
(graspnerf_tpu/sim/world.py).

The reference evaluates with pybullet physics + Blender Cycles rendering
(ref: src/gd/simulation.py, gd/utils/btsim.py, rd/render.py). Here the same
closed loop is served by in-repo components with no external engines:

  SimWorld       — the flagship eval world: `ClutterRemovalSim` (pile/packed
                   scene generation, SDF settling, ray-cast finger closing,
                   antipodal/friction/pinned checks — sim/simulation.py) plus
                   the `DomainRandomizer` renderer (randomized materials /
                   lights / floor textures — sim/render.py, the rd/ analog).
                   This mirrors the reference's sim+Blender pairing
                   (clutter_removal.py:55-78) in-process.
  AnalyticWorld  — a deliberately simple smoke-test fixture (sphere/box
                   scenes, TCP-near-surface success model). Used only to keep
                   harness tests fast; NOT a model-quality signal.

Both expose: reset(n_objects); num_objects; observe(pose, K, h, w) →
(rgb, depth); execute_grasp(pose, width) → (Label, width).

pybullet note: the environment intentionally has no pybullet (no installs);
SimWorld's ray-cast gripper state machine is the physics analog. A BtWorld-
style adapter would slot in behind the same 4-method interface.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..data.synthetic import Scene
from .grasp import Label
from .transform import Transform
from .simulation import ClutterRemovalSim
from .render import DomainRandomizer, render_scene


class SimWorld:
    """ClutterRemovalSim + DomainRandomizer behind the World interface
    (the in-process analog of ref clutter_removal.py:55-78: pybullet sim +
    blender_init_scene/blender_render/blender_update_sceneobj)."""

    def __init__(self, scene: str = "pile",
                 rng: Optional[np.random.RandomState] = None,
                 use_dr: bool = True, allow_contact: bool = True,
                 device=None):
        self.rng = rng or np.random.RandomState(0)
        # device: the TSDF fusion's, the card unless given
        self.sim = ClutterRemovalSim(scene, rng=self.rng, device=device)
        self.use_dr = use_dr
        self.allow_contact = allow_contact
        self.dr: Optional[DomainRandomizer] = None

    def reset(self, n_objects: int = 4):
        self.sim.reset(n_objects)
        if self.use_dr:
            # per-scene randomization seed (ref rd/render.py:10-18)
            self.dr = DomainRandomizer(self.rng).init_scene(self.sim.scene)
        return self.sim.scene

    @property
    def num_objects(self) -> int:
        return self.sim.num_objects

    def observe(self, pose, K, h: int, w: int):
        """Render RGB-D from a world→cam pose [3,4] with the DR renderer."""
        rgb, depth, _ = render_scene(self.sim.scene, pose, K, h, w, self.dr)
        return rgb, depth

    def acquire_tsdf(self, n_views: int = 6, resolution: int = 40,
                     h: int = 96, w: int = 128):
        """GT/diagnostic TSDF from sim depth renders (ref simulation.py:
        341-367)."""
        tsdf, _, t_int = self.sim.acquire_tsdf(
            n_views=n_views, resolution=resolution,
            high_resolution=resolution, h=h, w=w)
        return tsdf, t_int

    def execute_grasp(self, pose: Transform, width: float
                      ) -> Tuple[Label, float]:
        (label, out_width), _ = self.sim.execute_grasp(
            (pose, width), remove=True, allow_contact=self.allow_contact)
        if self.dr is not None:
            # survivors keep their materials (ref blender_update_sceneobj)
            self.dr.update_sceneobj(self.sim.scene)
        return label, out_width


class AnalyticWorld:
    """Geometric smoke-test world: a grasp succeeds when the TCP is within
    `surface_tol` of an object that fits the gripper opening. Fast and
    deterministic; use SimWorld for real evaluation."""

    def __init__(self, rng: np.random.RandomState | None = None,
                 surface_tol: float = 0.01, max_opening: float = 0.08,
                 z_min: float = 0.005):
        self.rng = rng or np.random.RandomState(0)
        self.surface_tol = surface_tol
        self.max_opening = max_opening
        self.z_min = z_min
        self.scene: Scene | None = None

    def reset(self, n_objects: int = 4) -> Scene:
        self.scene = Scene(self.rng, n_objects)
        return self.scene

    @property
    def num_objects(self) -> int:
        return len(self.scene.spheres) + len(self.scene.boxes)

    def observe(self, pose, K, h: int, w: int):
        """Render RGB-D from a world→cam pose [3,4]."""
        rgb, depth, _ = self.scene.render(pose, K, h, w)
        return rgb, depth

    # ------------------------------------------------------------- grasping
    def _object_distances(self, p: np.ndarray):
        """Distance from point p to each object's surface + object size."""
        dists, sizes = [], []
        for c, r in self.scene.spheres:
            dists.append(abs(np.linalg.norm(p - c) - r))
            sizes.append(2 * r)
        for lo, hi in self.scene.boxes:
            q = np.maximum(lo - p, np.maximum(0.0, p - hi))
            outside = np.linalg.norm(q)
            inside = min(np.min(p - lo), np.min(hi - p))
            dists.append(outside if outside > 0 else abs(inside))
            sizes.append(float(np.min(hi - lo)))
        return np.asarray(dists), np.asarray(sizes)

    def execute_grasp(self, pose: Transform, width: float,
                      remove: bool = True) -> Tuple[Label, float]:
        p = np.asarray(pose.translation, np.float64)
        if self.num_objects == 0 or p[2] < self.z_min:
            return Label.FAILURE, 0.0
        dists, sizes = self._object_distances(p)
        i = int(np.argmin(dists))
        graspable = (dists[i] < self.surface_tol
                     and sizes[i] <= self.max_opening
                     and width >= sizes[i] * 0.5)
        if not graspable:
            return Label.FAILURE, 0.0
        if remove:
            ns = len(self.scene.spheres)
            if i < ns:
                self.scene.spheres.pop(i)
            else:
                self.scene.boxes.pop(i - ns)
        return Label.SUCCESS, float(width)
