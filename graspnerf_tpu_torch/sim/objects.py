"""Oriented-primitive object models for the simulation harness
(graspnerf_tpu/sim/objects.py, the same numpy).

The reference simulates URDF mesh objects in pybullet (ref:
src/gd/simulation.py:158-338, gd/utils/btsim.py). This environment has no
pybullet and no mesh asset tree, so the TPU-native harness models objects as
oriented geometric primitives (sphere / box / cylinder / capsule) with three
consistent, vectorised geometric queries:

  sdf(points)        signed distance to the object surface  (collision,
                     settling, gripper contact)
  intersect(o, d)    analytic ray intersection (t, normal, hit) — rendering
                     and contact ray-casts
  surface_points(n)  quasi-uniform samples on the surface (support/collision
                     proxies)

A scene is a flat array-of-structs `PrimScene` so every query is a single
vectorised numpy pass per object (object counts are ~10; ray counts are 10^5 —
the loop is over objects, never over rays). The same flat encoding feeds the
native C++/OpenMP tracer (native/raytrace.cpp: trace_prims, built by
data/native.py). Without it `PrimScene.trace` warns once and traces with the
numpy intersects; `TRACES` counts the rays each tracer took.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np

from ..data import native

TYPE_SPHERE = 0   # params = (r, -, -)
TYPE_BOX = 1      # params = (hx, hy, hz) half-extents
TYPE_CYLINDER = 2  # params = (r, hz, -) capped, axis = local z
TYPE_CAPSULE = 3  # params = (r, hz, -) segment half-length hz, axis = local z

_EPS = 1e-9
# rays traced by PrimScene.trace, by tracer: {"native": n, "numpy": n}
TRACES = {"native": 0, "numpy": 0}


def _canonical_sdf(kind: int, p: np.ndarray, prm: np.ndarray) -> np.ndarray:
    """SDF of the canonical (unposed) primitive at points p [N,3]."""
    if kind == TYPE_SPHERE:
        return np.linalg.norm(p, axis=-1) - prm[0]
    if kind == TYPE_BOX:
        q = np.abs(p) - prm[None, :3]
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
        inside = np.minimum(np.max(q, axis=-1), 0.0)
        return outside + inside
    if kind == TYPE_CYLINDER:
        dxy = np.linalg.norm(p[:, :2], axis=-1) - prm[0]
        dz = np.abs(p[:, 2]) - prm[1]
        d = np.stack([dxy, dz], -1)
        outside = np.linalg.norm(np.maximum(d, 0.0), axis=-1)
        inside = np.minimum(np.max(d, axis=-1), 0.0)
        return outside + inside
    if kind == TYPE_CAPSULE:
        z = np.clip(p[:, 2], -prm[1], prm[1])
        q = p - np.stack([np.zeros_like(z), np.zeros_like(z), z], -1)
        return np.linalg.norm(q, axis=-1) - prm[0]
    raise ValueError(f"unknown primitive type {kind}")


def _canonical_intersect(kind: int, o: np.ndarray, d: np.ndarray,
                         prm: np.ndarray):
    """Ray ∩ canonical primitive. o,d [N,3] (d unit). Returns
    (t [N] inf=miss, normal [N,3])."""
    N = o.shape[0]
    t_hit = np.full(N, np.inf, np.float32)
    n_hit = np.zeros((N, 3), np.float32)

    if kind in (TYPE_SPHERE, TYPE_CAPSULE):
        r = prm[0]
        if kind == TYPE_SPHERE:
            centers = [np.zeros(3, np.float32)]
        else:
            centers = [np.array([0, 0, -prm[1]], np.float32),
                       np.array([0, 0, prm[1]], np.float32)]
        for c in centers:
            oc = o - c
            b = np.sum(d * oc, -1)
            disc = b * b - (np.sum(oc * oc, -1) - r * r)
            ok = disc > 0
            t = np.where(ok, -b - np.sqrt(np.maximum(disc, 0.0)), np.inf)
            # capsule caps: only the hemispherical part outside the cylinder
            if kind == TYPE_CAPSULE:
                pz = o[:, 2] + t * d[:, 2]
                in_cap = np.where(c[2] < 0, pz <= -prm[1], pz >= prm[1])
                t = np.where(in_cap, t, np.inf)
            hit = (t > 1e-5) & (t < t_hit)
            p = o + d * t[:, None]
            n = (p - c) / max(r, _EPS)
            t_hit = np.where(hit, t, t_hit).astype(np.float32)
            n_hit = np.where(hit[:, None], n, n_hit).astype(np.float32)

    if kind in (TYPE_CYLINDER, TYPE_CAPSULE):
        r, hz = prm[0], prm[1]
        # infinite-cylinder side
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        b = o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1]
        c = o[:, 0] ** 2 + o[:, 1] ** 2 - r * r
        disc = b * b - a * c
        ok = (disc > 0) & (a > _EPS)
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = np.where(ok, (-b - sq) / np.where(a > _EPS, a, 1.0), np.inf)
        pz = o[:, 2] + t * d[:, 2]
        t = np.where(np.abs(pz) <= hz, t, np.inf)
        hit = (t > 1e-5) & (t < t_hit)
        p = o + d * t[:, None]
        n = np.stack([p[:, 0], p[:, 1], np.zeros(N, np.float32)],
                     -1) / max(r, _EPS)
        t_hit = np.where(hit, t, t_hit).astype(np.float32)
        n_hit = np.where(hit[:, None], n, n_hit).astype(np.float32)
        if kind == TYPE_CYLINDER:
            # end caps (discs at z = ±hz)
            for zc, nz in ((-hz, -1.0), (hz, 1.0)):
                dz = d[:, 2]
                t = np.where(np.abs(dz) > _EPS, (zc - o[:, 2])
                             / np.where(np.abs(dz) > _EPS, dz, 1.0), np.inf)
                p = o + d * t[:, None]
                on_disc = p[:, 0] ** 2 + p[:, 1] ** 2 <= r * r
                t = np.where(on_disc, t, np.inf)
                hit = (t > 1e-5) & (t < t_hit)
                t_hit = np.where(hit, t, t_hit).astype(np.float32)
                n_cap = np.array([0.0, 0.0, nz], np.float32)
                n_hit = np.where(hit[:, None], n_cap, n_hit).astype(np.float32)

    if kind == TYPE_BOX:
        h = prm[:3]
        inv = 1.0 / np.where(np.abs(d) < _EPS, np.copysign(_EPS, d), d)
        t0 = (-h - o) * inv
        t1 = (h - o) * inv
        tmin = np.minimum(t0, t1)
        tmax = np.maximum(t0, t1)
        tn = tmin.max(-1)
        tf = tmax.min(-1)
        ok = (tn < tf) & (tf > 0)
        t = np.where(ok & (tn > 1e-5), tn, np.inf)
        axis = np.argmax(tmin, -1)
        sign = -np.sign(np.take_along_axis(d, axis[:, None], 1))[:, 0]
        n = np.zeros((N, 3), np.float32)
        n[np.arange(N), axis] = sign
        hit = np.isfinite(t) & (t < t_hit)
        t_hit = np.where(hit, t, t_hit).astype(np.float32)
        n_hit = np.where(hit[:, None], n, n_hit).astype(np.float32)

    return t_hit, n_hit


def _canonical_surface_points(kind: int, prm: np.ndarray, n: int,
                              rng: np.random.RandomState) -> np.ndarray:
    """Quasi-uniform surface samples on the canonical primitive [n,3]."""
    u = rng.randn(n, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True) + _EPS
    if kind == TYPE_SPHERE:
        return (u * prm[0]).astype(np.float32)
    if kind == TYPE_BOX:
        # project unit directions onto the box via max-norm scaling
        h = prm[:3]
        s = np.max(np.abs(u) / h[None], axis=-1, keepdims=True)
        return (u / np.maximum(s, _EPS)).astype(np.float32)
    if kind == TYPE_CYLINDER:
        r, hz = prm[0], prm[1]
        theta = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(-hz, hz, n)
        pts = np.stack([r * np.cos(theta), r * np.sin(theta), z], -1)
        # mix in cap samples
        ncap = n // 4
        rr = r * np.sqrt(rng.uniform(0, 1, ncap))
        th = rng.uniform(0, 2 * np.pi, ncap)
        zc = np.where(rng.rand(ncap) < 0.5, -hz, hz)
        pts[:ncap] = np.stack([rr * np.cos(th), rr * np.sin(th), zc], -1)
        return pts.astype(np.float32)
    if kind == TYPE_CAPSULE:
        # area-proportional split: side 4*pi*r*hz vs caps 4*pi*r^2
        r, hz = float(prm[0]), float(prm[1])
        p_side = hz / max(hz + r, _EPS)
        on_side = rng.rand(n) < p_side
        theta = rng.uniform(0, 2 * np.pi, n)
        z_side = rng.uniform(-hz, hz, n)
        side = np.stack([r * np.cos(theta), r * np.sin(theta), z_side], -1)
        cap = u * r  # uniform sphere dirs scaled to radius
        cap[:, 2] += np.sign(cap[:, 2]) * hz  # shift each hemisphere to a cap
        pts = np.where(on_side[:, None], side, cap)
        return pts.astype(np.float32)
    raise ValueError(kind)


class PrimObject:
    """One posed primitive: world pose (R, t), canonical params, material id.

    Pose convention: world_point = R @ local_point + t.
    """

    def __init__(self, kind: int, params, R=None, t=None, material: int = 0,
                 name: str = ""):
        self.kind = int(kind)
        self.params = np.asarray(params, np.float32).reshape(3)
        self.R = (np.eye(3, dtype=np.float32) if R is None
                  else np.asarray(R, np.float32).reshape(3, 3))
        self.t = (np.zeros(3, np.float32) if t is None
                  else np.asarray(t, np.float32).reshape(3))
        self.material = int(material)
        self.name = name or f"prim{self.kind}"

    # ------------------------------------------------------------- queries
    def to_local(self, p: np.ndarray) -> np.ndarray:
        return (p - self.t) @ self.R  # == R.T @ (p - t) per row

    def to_world_dir(self, v: np.ndarray) -> np.ndarray:
        return v @ self.R.T

    def sdf(self, points: np.ndarray) -> np.ndarray:
        return _canonical_sdf(self.kind, self.to_local(
            np.asarray(points, np.float32).reshape(-1, 3)), self.params)

    def intersect(self, origins: np.ndarray, dirs: np.ndarray):
        o = self.to_local(origins.astype(np.float32))
        d = dirs.astype(np.float32) @ self.R
        t, n = _canonical_intersect(self.kind, o, d, self.params)
        return t, self.to_world_dir(n)

    def surface_points(self, n: int = 128,
                       rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState(0)
        pts = _canonical_surface_points(self.kind, self.params, n, rng)
        return pts @ self.R.T + self.t

    # --------------------------------------------------------------- misc
    @property
    def radius_bound(self) -> float:
        """Bounding-sphere radius about t."""
        if self.kind == TYPE_SPHERE:
            return float(self.params[0])
        if self.kind == TYPE_BOX:
            return float(np.linalg.norm(self.params))
        if self.kind == TYPE_CAPSULE:
            # caps extend the half-length by the radius
            return float(self.params[0] + self.params[1])
        return float(np.hypot(self.params[0], self.params[1]))

    @property
    def min_width(self) -> float:
        """Smallest caliper width — what a parallel gripper must open to."""
        if self.kind == TYPE_SPHERE:
            return float(2 * self.params[0])
        if self.kind == TYPE_BOX:
            return float(2 * np.min(self.params))
        return float(2 * self.params[0])

    @property
    def volume(self) -> float:
        r, h = float(self.params[0]), float(self.params[1])
        if self.kind == TYPE_SPHERE:
            return 4 / 3 * np.pi * r ** 3
        if self.kind == TYPE_BOX:
            return float(8 * np.prod(self.params))
        if self.kind == TYPE_CYLINDER:
            return 2 * np.pi * r * r * h
        return 2 * np.pi * r * r * h + 4 / 3 * np.pi * r ** 3

    def flat(self) -> np.ndarray:
        """16-float encoding for the native tracer:
        [kind, R row-major (9), t (3), params (3)]."""
        return np.concatenate([[np.float32(self.kind)], self.R.reshape(9),
                               self.t, self.params]).astype(np.float32)

    def state(self) -> dict:
        return {"kind": self.kind, "params": self.params.copy(),
                "R": self.R.copy(), "t": self.t.copy(),
                "material": self.material, "name": self.name}

    @classmethod
    def from_state(cls, s: dict) -> "PrimObject":
        return cls(s["kind"], s["params"], s["R"], s["t"],
                   int(s.get("material", 0)), str(s.get("name", "")))


class PrimScene:
    """A set of PrimObjects + the table plane z=0.

    Queries return object ids: 0..n-1 for objects, n for the table,
    -1 for miss.
    """

    def __init__(self, objects: Optional[List[PrimObject]] = None):
        self.objects: List[PrimObject] = list(objects or [])

    # ------------------------------------------------------------ queries
    @property
    def table_id(self) -> int:
        return len(self.objects)

    def sdf(self, points: np.ndarray, exclude: int = -1,
            with_table: bool = False) -> np.ndarray:
        """min over objects (and optionally the table half-space z<0)."""
        points = np.asarray(points, np.float32).reshape(-1, 3)
        best = np.full(points.shape[0], np.inf, np.float32)
        for i, ob in enumerate(self.objects):
            if i == exclude:
                continue
            best = np.minimum(best, ob.sdf(points))
        if with_table:
            best = np.minimum(best, points[:, 2])
        return best

    def trace(self, origins: np.ndarray, dirs: np.ndarray,
              exclude: int = -1, with_table: bool = True):
        """First hit along rays. Returns (t [N] inf=miss, normals [N,3],
        ids [N] int32). Analytic primitives and triangle meshes both route
        through the native C++ tracer when available (trace_prims +
        BVH trace_tris); the per-object numpy intersects below are the
        oracle fallback, with a RuntimeWarning."""
        origins = np.ascontiguousarray(origins, np.float32).reshape(-1, 3)
        dirs = np.ascontiguousarray(dirs, np.float32).reshape(-1, 3)
        N = origins.shape[0]
        t_best = np.full(N, np.inf, np.float32)
        n_best = np.zeros((N, 3), np.float32)
        id_best = np.full(N, -1, np.int32)

        prim_ids = [i for i, ob in enumerate(self.objects)
                    if ob.kind < 4 and i != exclude]
        mesh_ids = [i for i, ob in enumerate(self.objects)
                    if ob.kind >= 4 and i != exclude]
        use_native = native.prims_available()
        use_tris = use_native and native.tris_available()
        if prim_ids or mesh_ids:
            fast = use_native and (use_tris or not mesh_ids)
            if not fast:   # shown once per process (the default filter)
                warnings.warn("the native ray tracer is unavailable: "
                              "PrimScene.trace runs its numpy intersects",
                              RuntimeWarning, stacklevel=2)
            TRACES["native" if fast else "numpy"] += N

        if prim_ids:
            if use_native:
                prims = np.stack([self.objects[i].flat() for i in prim_ids])
                t, n, ids = native.trace_prims(prims, origins, dirs, False)
                remap = np.asarray(prim_ids + [-1], np.int32)
                ids = remap[np.where(ids >= 0, ids, len(prim_ids))]
                hit = t < t_best
                t_best = np.where(hit, t, t_best)
                n_best = np.where(hit[:, None], n, n_best)
                id_best = np.where(hit, ids, id_best)
            else:
                for i in prim_ids:
                    t, n = self.objects[i].intersect(origins, dirs)
                    hit = t < t_best
                    t_best = np.where(hit, t, t_best)
                    n_best = np.where(hit[:, None], n, n_best)
                    id_best = np.where(hit, i, id_best)
        if mesh_ids:
            if use_tris:
                tris = np.concatenate(
                    [self.objects[i].world_triangles() for i in mesh_ids])
                tids = np.concatenate(
                    [np.full(len(self.objects[i].faces), i, np.int32)
                     for i in mesh_ids])
                t, n, ids = native.trace_tris(tris, tids, origins, dirs)
                hit = t < t_best
                t_best = np.where(hit, t, t_best)
                n_best = np.where(hit[:, None], n, n_best)
                id_best = np.where(hit, ids, id_best)
            else:
                for i in mesh_ids:
                    t, n = self.objects[i].intersect(origins, dirs)
                    hit = t < t_best
                    t_best = np.where(hit, t, t_best)
                    n_best = np.where(hit[:, None], n, n_best)
                    id_best = np.where(hit, i, id_best)
        if with_table:
            dz = dirs[:, 2]
            t = np.where(np.abs(dz) > _EPS, -origins[:, 2]
                         / np.where(np.abs(dz) > _EPS, dz, 1.0), np.inf)
            hit = (t > 1e-5) & (t < t_best)
            t_best = np.where(hit, t, t_best)
            n_best = np.where(hit[:, None],
                              np.array([0, 0, 1], np.float32), n_best)
            id_best = np.where(hit, self.table_id, id_best)
        return t_best, n_best, id_best

    # ---------------------------------------------------------- mutation
    def add(self, obj: PrimObject) -> int:
        self.objects.append(obj)
        return len(self.objects) - 1

    def remove(self, idx: int) -> PrimObject:
        return self.objects.pop(idx)

    def __len__(self) -> int:
        return len(self.objects)

    # ------------------------------------------------------- (de)serialise
    def save(self, path: str):
        """Scene descriptor npz — the analog of the reference's saved
        mesh_pose_dict scene descriptors (ref simulation.py:85-96). Mesh
        objects carry their vertex/face arrays in a pickled states column."""
        n = len(self.objects)
        mesh_states = [o.state() for o in self.objects if o.kind >= 4]
        np.savez_compressed(
            path,
            kinds=np.array([o.kind for o in self.objects], np.int32),
            params=(np.stack([o.params for o in self.objects])
                    if n else np.zeros((0, 3), np.float32)),
            Rs=(np.stack([o.R for o in self.objects])
                if n else np.zeros((0, 3, 3), np.float32)),
            ts=(np.stack([o.t for o in self.objects])
                if n else np.zeros((0, 3), np.float32)),
            materials=np.array([o.material for o in self.objects], np.int32),
            mesh_states=np.array(mesh_states, dtype=object),
        )

    @classmethod
    def load(cls, path: str) -> "PrimScene":
        z = np.load(path, allow_pickle=True)
        mesh_states = list(z["mesh_states"]) if "mesh_states" in z else []
        objs = []
        for i in range(len(z["kinds"])):
            kind = int(z["kinds"][i])
            if kind >= 4:
                from .mesh import MeshObject
                objs.append(MeshObject.from_state(mesh_states.pop(0)))
            else:
                objs.append(PrimObject(kind, z["params"][i], z["Rs"][i],
                                       z["ts"][i], int(z["materials"][i])))
        return cls(objs)


def random_object(rng: np.random.RandomState, scale: float = 1.0,
                  kinds=(TYPE_SPHERE, TYPE_BOX, TYPE_CYLINDER, TYPE_CAPSULE)
                  ) -> PrimObject:
    """Random household-scale object (2-8 cm), analog of the reference's
    random URDF pick + scale jitter (ref simulation.py:168-178)."""
    kind = int(kinds[rng.randint(len(kinds))])
    if kind == TYPE_SPHERE:
        prm = [rng.uniform(0.015, 0.035) * scale, 0, 0]
    elif kind == TYPE_BOX:
        prm = list(rng.uniform(0.012, 0.035, 3) * scale)
    elif kind == TYPE_CYLINDER:
        prm = [rng.uniform(0.012, 0.03) * scale,
               rng.uniform(0.02, 0.05) * scale, 0]
    else:
        prm = [rng.uniform(0.01, 0.022) * scale,
               rng.uniform(0.015, 0.04) * scale, 0]
    return PrimObject(kind, prm, material=rng.randint(0, 8))
