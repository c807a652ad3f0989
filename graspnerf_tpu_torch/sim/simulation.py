"""Physics-free clutter-removal simulator (graspnerf_tpu/sim/simulation.py;
ref: src/gd/simulation.py:13-558).

The reference drives pybullet for scene generation (drop/settle piles, packed
upright placement), gripper execution (pregrasp -> approach -> close ->
retreat with contact checks), and cleanup (resettle + discard objects that
leave the workspace). This environment has no pybullet, so the TPU-native
harness replaces dynamics with the geometric queries every step actually
needs, computed on the SDF/ray primitives of `sim.objects`:

  drop/settle      support-height ray casts under the object's surface
                   samples (quasi-static resting pose; no tumbling)
  contact checks   scene SDF at gripper-body proxy points
  finger closing   ray casts along the finger closing line (+/- grasp-frame
                   y), giving per-finger contact point, normal and object id
  grasp success    both fingers contact the same object, antipodal normals
                   within the friction cone, residual width > 0.1 * max
                   opening (the reference's check_success,
                   ref simulation.py:465-469), and the object is not
                   pinned from above
  remove_and_wait  re-settle survivors and discard out-of-workspace bodies
                   (ref simulation.py:424-463)

Everything is deterministic given the RNG — the property the reference's
saved-scene replay relies on.

Coordinates: table plane z=0; workspace = [-0.15, 0.15]^2 x [-0.05, 0.25]
(the volume bbox of data.synthetic.BBOX_MIN..+VOLUME_SIZE); the 40^3 TSDF is
volume-local like the reference's (ref utils/field_utils.py:12-27).

Geometry, shading and the grasp state machine are numpy on the host, as in
the JAX package, so that scenes and images are bit-equal to its; the depth
fusion of `acquire_tsdf` runs on the simulator's `device` (the card unless
the caller passes another, `models.resolve_device`).
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

import torch

from ..data.synthetic import BBOX_MIN, hemisphere_poses, intrinsics
from ..models import resolve_device
from ..ops.tsdf import integrate_tsdf, VOLUME_SIZE
from .grasp import Grasp, Label
from .objects import PrimObject, PrimScene, random_object
from .transform import Rotation, Transform

WORKSPACE_LO = np.array([-0.15, -0.15, -0.01], np.float32)
WORKSPACE_HI = np.array([0.15, 0.15, 0.30], np.float32)
_DROP_CEILING = 1.0


class GripperGeometry:
    """Panda-hand proxy (ref simulation.py:472-479): parallel jaw, max
    opening 0.08 m, finger depth 0.05 m. The body is approximated by proxy
    point clouds (palm slab + two finger slabs) expressed in the TCP frame
    (z = approach, y = closing line)."""

    max_opening_width = 0.08
    finger_depth = 0.05
    finger_thickness = 0.008
    finger_height = 0.018   # extent along x
    palm_half = np.array([0.012, 0.05, 0.012], np.float32)

    def body_points(self, width: float, n_len: int = 6, n_w: int = 3
                    ) -> np.ndarray:
        """Collision-proxy points in the TCP frame for a given opening."""
        pts = []
        zs = np.linspace(-self.finger_depth, 0.0, n_len, dtype=np.float32)
        xs = np.linspace(-self.finger_height / 2, self.finger_height / 2,
                         n_w, dtype=np.float32)
        for side in (-1.0, 1.0):
            y = side * (width / 2 + self.finger_thickness / 2)
            g = np.stack(np.meshgrid(xs, [y], zs, indexing="ij"),
                         -1).reshape(-1, 3)
            pts.append(g)
        # palm slab behind the fingers
        ys = np.linspace(-width / 2 - self.finger_thickness,
                         width / 2 + self.finger_thickness, 7,
                         dtype=np.float32)
        zs_p = np.linspace(-self.finger_depth - 0.02,
                           -self.finger_depth, 3, dtype=np.float32)
        g = np.stack(np.meshgrid(xs, ys, zs_p, indexing="ij"),
                     -1).reshape(-1, 3)
        pts.append(g)
        return np.concatenate(pts, 0).astype(np.float32)


class ClutterRemovalSim:
    """Scene generation + closed-loop grasp execution
    (ref simulation.py:13-469)."""

    def __init__(self, scene: str = "pile", rng=None,
                 gripper: Optional[GripperGeometry] = None,
                 friction_cos: float = 0.6, device=None):
        assert scene in ("pile", "packed", "single")
        self.device = resolve_device(device)   # the TSDF fusion's
        self.scene_type = scene
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.gripper = gripper or GripperGeometry()
        self.friction_cos = friction_cos  # cos of the friction-cone half-angle
        self.scene = PrimScene()

    # ------------------------------------------------------------ scene gen
    @property
    def num_objects(self) -> int:
        return len(self.scene)

    def reset(self, object_count: int = 5) -> PrimScene:
        """Generate a fresh scene (ref simulation.py:98-156 reset +
        generate_*_scene)."""
        self.scene = PrimScene()
        if self.scene_type == "pile":
            self._generate_pile(object_count)
        elif self.scene_type == "packed":
            self._generate_packed(object_count)
        else:
            self._generate_single()
        self.remove_and_wait()
        return self.scene

    def reset_from_descriptor(self, path: str) -> PrimScene:
        """Replay a saved scene (ref simulation.py:85-96 descriptor npz)."""
        self.scene = PrimScene.load(path)
        return self.scene

    def reset_from_mesh_pose_list(self, path: str, asset_root: str = ""
                                  ) -> PrimScene:
        """Replay a reference-format `mesh_pose_list` descriptor (coordinates
        are translated into this repo's center-origin frame by
        mesh.load_mesh_pose_list). Placement mirrors ref simulation.py:
          pile spawn entries  drop from table+0.2 and settle sequentially
                              (:177-191)
          pile rest poses     placed exactly at the recorded rest pose
                              (:201-203; minimal depenetration only)
          packed entries      upright at the recorded xy, z = half the world
                              AABB height + 2 mm, REJECTED on contact instead
                              of settled (:245-255)
        then remove_and_wait cleanup (:424-463)."""
        from .mesh import load_mesh_pose_list
        entries = load_mesh_pose_list(path, asset_root, self.scene_type)
        self.scene = PrimScene()
        for e in entries:
            obj = e["mesh"]
            if self.scene_type == "packed":
                tris = obj.world_triangles()
                half_h = 0.5 * (tris[..., 2].max() - tris[..., 2].min())
                obj.t = np.array([obj.t[0], obj.t[1], half_h + 0.002],
                                 np.float32)
                idx = self.scene.add(obj)
                pts = obj.surface_points(256, self.rng)
                d = self.scene.sdf(pts, exclude=idx, with_table=True)
                if float(np.min(d)) < -1e-4:   # in contact -> reject
                    self.scene.remove(idx)
                continue
            idx = self.scene.add(obj)
            if not e.get("rest", False):
                drop = self._support_drop(obj, idx_exclude=idx)
                obj.t[2] -= drop
            self._depenetrate_up(idx)
        self.remove_and_wait()
        return self.scene

    def save_descriptor(self, path: str):
        self.scene.save(path)

    def _random_rotation(self) -> np.ndarray:
        q = self.rng.randn(4)
        q /= np.linalg.norm(q)
        return Rotation.from_quat(q).as_matrix().astype(np.float32)

    def _yaw_rotation(self) -> np.ndarray:
        a = self.rng.uniform(0, 2 * np.pi)
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    def _support_drop(self, obj: PrimObject, idx_exclude: int = -1) -> float:
        """Distance the object can fall straight down before first contact
        (surface-sample support ray casts; quasi-static settle)."""
        pts = obj.surface_points(96, self.rng)
        down = np.tile(np.array([[0, 0, -1]], np.float32), (len(pts), 1))
        t, _, _ = self.scene.trace(pts, down, exclude=idx_exclude,
                                   with_table=True)
        t = np.where(np.isfinite(t), t, _DROP_CEILING)
        return float(max(np.min(t), 0.0))

    def _depenetrate_up(self, idx: int, tol: float = -1e-3,
                        step: float = 1e-3, max_iter: int = 200):
        # fresh surface samples every check: a single sparse sample can miss
        # the deepest penetration, so require two consecutive clean checks
        obj = self.scene.objects[idx]
        clean = 0
        for _ in range(max_iter):
            pts = obj.surface_points(256, self.rng)
            d = self.scene.sdf(pts, exclude=idx, with_table=True)
            if float(np.min(d)) >= tol:
                clean += 1
                if clean >= 2:
                    return
                continue
            clean = 0
            obj.t[2] += step

    def _drop_object(self, obj: PrimObject):
        """Pile-style placement: random pose high above the workspace, then
        settle straight down onto table/pile (ref simulation.py:158-203)."""
        obj.R = self._random_rotation()
        margin = obj.radius_bound
        obj.t = np.array([self.rng.uniform(-0.10 + margin, 0.10 - margin),
                          self.rng.uniform(-0.10 + margin, 0.10 - margin),
                          0.5], np.float32)
        idx = self.scene.add(obj)
        drop = self._support_drop(obj, idx_exclude=idx)
        obj.t[2] -= drop
        self._depenetrate_up(idx)

    def _generate_pile(self, n: int):
        for _ in range(n):
            self._drop_object(random_object(self.rng))

    def _generate_packed(self, n: int, max_attempts: int = 12):
        """Upright placement with contact rejection
        (ref simulation.py:205-271)."""
        placed = 0
        attempts = 0
        while placed < n and attempts < n * max_attempts:
            attempts += 1
            obj = random_object(self.rng)
            obj.R = self._yaw_rotation()
            # upright support offset: lowest surface point above the table
            base = -float(np.min(obj.surface_points(128, self.rng)[:, 2]
                                 - obj.t[2]))
            margin = obj.radius_bound
            obj.t = np.array([self.rng.uniform(-0.11 + margin, 0.11 - margin),
                              self.rng.uniform(-0.11 + margin, 0.11 - margin),
                              base + 1e-4], np.float32)
            pts = obj.surface_points(96, self.rng)
            if len(self.scene) and float(np.min(self.scene.sdf(pts))) < 5e-3:
                continue  # reject contact with an existing body
            self.scene.add(obj)
            placed += 1

    def _generate_single(self):
        obj = random_object(self.rng)
        obj.R = self._yaw_rotation()
        base = -float(np.min(obj.surface_points(128, self.rng)[:, 2]
                             - obj.t[2]))
        obj.t = np.array([self.rng.uniform(-0.03, 0.03),
                          self.rng.uniform(-0.03, 0.03), base], np.float32)
        self.scene.add(obj)

    # -------------------------------------------------------------- sensing
    def observe(self, pose: np.ndarray, K: np.ndarray, h: int, w: int,
                renderer=None):
        """RGB-D from a world->cam pose [3,4]. RGB via the DR renderer when
        given, else flat Lambert shading."""
        from .render import render_scene  # local import: render deps on us
        return render_scene(self.scene, pose, K, h, w, randomizer=renderer)

    def acquire_tsdf(self, n_views: int = 6, resolution: int = 40,
                     high_resolution: int = 120, h: int = 96, w: int = 128):
        """Depth-fusion GT TSDF from n_views on the hemisphere
        (ref simulation.py:341-367: 40^3 planner grid + 120^3 diagnostics),
        fused on the simulator's device. Returns (tsdf, tsdf_hi,
        integration_time) with numpy volumes; the time covers the fusion
        and its copy back, not the depth renders."""
        poses = hemisphere_poses()[:n_views * 4:4][:n_views]
        K = intrinsics(h, w)
        shift = np.eye(4, dtype=np.float32)
        shift[:3, 3] = BBOX_MIN
        depths, exts, Ks = [], [], []
        for pose in poses:
            _, depth, _ = self.observe(pose, K, h, w)
            depths.append(depth)
            ext = np.eye(4, dtype=np.float32)
            ext[:3, :] = pose
            exts.append(ext @ shift)
            Ks.append(K)
        t0 = time.time()
        out = []
        for res in (resolution, high_resolution):
            tsdf, wgt = integrate_tsdf(np.stack(depths), np.stack(Ks),
                                       np.stack(exts), VOLUME_SIZE, res,
                                       device=self.device)
            tsdf = torch.where(wgt > 0, tsdf, -1.0)
            out.append(tsdf.cpu().numpy())
        return out[0], out[1], time.time() - t0

    # ------------------------------------------------------------- grasping
    def _tcp_frame(self, pose: Transform):
        R = pose.rotation.as_matrix().astype(np.float32)
        return R[:, 0], R[:, 1], R[:, 2], \
            np.asarray(pose.translation, np.float32)

    def _body_collides(self, pose: Transform, width: float,
                       clearance: float = 0.0) -> bool:
        R = pose.rotation.as_matrix().astype(np.float32)
        t = np.asarray(pose.translation, np.float32)
        pts = self.gripper.body_points(width) @ R.T + t
        d = self.scene.sdf(pts, with_table=True)
        return bool(np.min(d) < clearance)

    def _close_fingers(self, pose: Transform):
        """Ray-cast the finger sweep. Returns (width, obj_id, cos_antipodal)
        or (None, -1, 0) when a finger misses."""
        g = self.gripper
        x, y, z, t = self._tcp_frame(pose)
        # contact rays start outside the opening, along the pad surface
        zs = np.linspace(-g.finger_depth * 0.9, -g.finger_depth * 0.1, 5,
                         dtype=np.float32)
        xs = np.linspace(-g.finger_height / 2, g.finger_height / 2, 3,
                         dtype=np.float32)
        grid = np.stack(np.meshgrid(xs, zs, indexing="ij"), -1).reshape(-1, 2)
        results = []
        for side in (-1.0, 1.0):
            origins = (t[None] + side * (g.max_opening_width / 2) * y[None]
                       + grid[:, :1] * x[None] + grid[:, 1:] * z[None])
            dirs = np.tile((-side * y)[None], (len(origins), 1))
            tt, nn, ids = self.scene.trace(
                origins.astype(np.float32), dirs.astype(np.float32),
                with_table=False)
            tt = np.where(tt <= g.max_opening_width, tt, np.inf)
            if not np.isfinite(tt).any():
                return None, -1, 0.0
            i = int(np.argmin(tt))
            results.append((float(tt[i]), nn[i], int(ids[i]), side))
        (t1, n1, id1, s1), (t2, n2, id2, s2) = results
        width = g.max_opening_width - t1 - t2
        if id1 != id2 or id1 < 0:
            return None, -1, 0.0
        # antipodal: each contact normal must oppose its finger's motion
        c1 = float(np.dot(n1, -s1 * y))  # finger 1 moves along -s1*y
        c2 = float(np.dot(n2, -s2 * y))
        cos_ok = min(-c1, -c2)  # want normals opposing motion
        return max(width, 0.0), id1, cos_ok

    def _pinned_from_above(self, idx: int, max_gap: float = 0.01,
                           frac: float = 0.4) -> bool:
        """True when another object rests on top (object can't be lifted)."""
        obj = self.scene.objects[idx]
        pts = obj.surface_points(128, self.rng)
        top = pts[pts[:, 2] >= np.percentile(pts[:, 2], 70)]
        up = np.tile(np.array([[0, 0, 1]], np.float32), (len(top), 1))
        # start slightly below the surface so resting contact (separation 0)
        # is not lost to the tracer's t > eps guard
        eps = 2e-3
        t, _, ids = self.scene.trace(top - eps * up, up, exclude=idx,
                                     with_table=False)
        blocked = np.isfinite(t) & (t < max_gap + eps) & (ids >= 0)
        return bool(np.mean(blocked) > frac)

    def execute_grasp(self, grasp, remove: bool = True,
                      allow_contact: bool = False
                      ) -> Tuple[Tuple[Label, float], List[dict]]:
        """Pregrasp -> approach -> close -> retreat state machine
        (ref simulation.py:369-422). Accepts a Grasp or a (pose, width)
        pair. Returns ((label, width), remaining-object states)."""
        pose, _ = grasp if not isinstance(grasp, Grasp) else (grasp.pose,
                                                              grasp.width)
        g = self.gripper
        z_axis = pose.rotation.as_matrix()[:, 2]
        pregrasp = Transform(pose.rotation,
                             np.asarray(pose.translation) - 0.05 * z_axis)

        result = None
        if self._body_collides(pregrasp, g.max_opening_width):
            result = (Label.FAILURE, g.max_opening_width)  # pregrasp contact
        else:
            # approach in 2 mm steps, abort on contact
            # (ref Gripper.move_tcp_xyz eef_step=0.002)
            n_steps = max(int(0.05 / 0.002), 1)
            contact = False
            stop_pose = pose  # last collision-free TCP pose on the descent
            for k in range(1, n_steps + 1):
                tcp = Transform(pose.rotation,
                                np.asarray(pregrasp.translation)
                                + z_axis * (0.05 * k / n_steps))
                if self._body_collides(tcp, g.max_opening_width):
                    contact = True
                    stop_pose = Transform(
                        pose.rotation,
                        np.asarray(pregrasp.translation)
                        + z_axis * (0.05 * (k - 1) / n_steps))
                    break
            if contact and not allow_contact:
                result = (Label.FAILURE, g.max_opening_width)
            else:
                # with allow_contact the descent stops at the contact point
                # and the fingers close from the stopped pose (ref
                # simulation.py:369-422 aborts move_tcp_xyz on contact)
                close_pose = stop_pose if contact else pose
                width, obj_id, cos_ok = self._close_fingers(close_pose)
                success = (width is not None
                           and width > 0.1 * g.max_opening_width
                           and cos_ok >= self.friction_cos
                           and not self._pinned_from_above(obj_id))
                if success:
                    result = (Label.SUCCESS, float(width))
                    if remove:
                        self.scene.remove(obj_id)
                else:
                    result = (Label.FAILURE, g.max_opening_width)

        remaining = []
        if remove:
            remaining = self.remove_and_wait()
        return result, remaining

    # -------------------------------------------------------------- cleanup
    def remove_and_wait(self) -> List[dict]:
        """Re-settle survivors, discard out-of-workspace bodies; returns the
        surviving object states (ref simulation.py:424-463)."""
        changed = True
        while changed:
            self._settle_all()
            changed = self._remove_outside_workspace()
        return [ob.state() for ob in self.scene.objects]

    def _settle_all(self, tol: float = 1e-3, max_rounds: int = 10):
        for _ in range(max_rounds):
            moved = 0.0
            order = np.argsort([ob.t[2] for ob in self.scene.objects])
            for i in order:
                drop = self._support_drop(self.scene.objects[i],
                                          idx_exclude=int(i))
                if drop > tol:
                    self.scene.objects[i].t[2] -= drop
                    self._depenetrate_up(int(i))
                    moved = max(moved, drop)
            if moved <= tol:
                return

    def _remove_outside_workspace(self) -> bool:
        removed = False
        for i in reversed(range(len(self.scene))):
            p = self.scene.objects[i].t
            if np.any(p < WORKSPACE_LO) or np.any(p > WORKSPACE_HI):
                self.scene.remove(i)
                removed = True
        return removed
