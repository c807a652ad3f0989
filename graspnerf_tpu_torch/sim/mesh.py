"""Triangle-mesh objects for the simulation harness + reference scene replay
(graspnerf_tpu/sim/mesh.py, the same numpy).

The reference evaluates on URDF mesh object sets loaded into pybullet
(ref src/gd/simulation.py:158-338) and replays saved `mesh_pose_list`
descriptors: `np.load(npz, allow_pickle=True).item()` -> a dict
{i: [scale, quat_xyzw, xy, urdf_path]} for pile scenes and
{i: [scale, angle, x, y, urdf_path]} for packed scenes
(ref src/gd/simulation.py:85-96, 158-271).

This module supplies the mesh analog of `sim.objects.PrimObject`:

  MeshObject        posed triangle mesh with the same query surface
                    (sdf / intersect / surface_points / radius_bound / ...)
  load_obj          minimal Wavefront OBJ reader (v / f lines, fan
                    triangulation) -- no trimesh in this environment
  mesh_from_urdf    resolve the first collision/visual <mesh> of a URDF
  load_mesh_pose_list   parse a reference-format descriptor npz into
                    (MeshObject, drop-pose) entries for replay

Ray intersection is Moller-Trumbore, vectorised over (rays x triangles)
in chunks; the native C++/OpenMP BVH tracer (native/raytrace.cpp:
trace_tris) takes over inside PrimScene.trace when built. The SDF is
distance-to-sampled-surface with the sign from ray-parity (inside test),
which is exact enough for the quasi-static settle / contact checks the
harness performs.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

import numpy as np

from .transform import Rotation

TYPE_MESH = 4
_EPS = 1e-9


# --------------------------------------------------------------------- IO
def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader -> (vertices [V,3] f32, faces [F,3] i32).

    Handles `v x y z` and `f a b c ...` (with optional /vt/vn suffixes);
    polygons are fan-triangulated. Negative indices are resolved per spec.
    """
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts or not faces:
        raise ValueError(f"no geometry in OBJ {path}")
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32))


def mesh_from_urdf(urdf_path: str) -> Tuple[str, np.ndarray]:
    """First <mesh filename=... scale=...> of a URDF (collision preferred,
    visual fallback) -> (absolute mesh path, scale [3]). Matches how the
    reference's pybullet loadURDF consumes its object set
    (ref src/gd/utils/btsim.py load_urdf)."""
    root = ET.parse(urdf_path).getroot()
    for section in ("collision", "visual"):
        for m in root.iter(section):
            mesh = m.find("./geometry/mesh")
            if mesh is None:
                continue
            fn = mesh.get("filename", "")
            fn = re.sub(r"^package://", "", fn)
            if not os.path.isabs(fn):
                fn = os.path.join(os.path.dirname(urdf_path), fn)
            scale = np.fromstring(mesh.get("scale", "1 1 1"), sep=" ")
            return fn, scale.astype(np.float32)
    raise ValueError(f"no <mesh> in URDF {urdf_path}")


# ------------------------------------------------------ ray intersection
def moller_trumbore(o: np.ndarray, d: np.ndarray, tri: np.ndarray,
                    eps: float = 1e-7):
    """Rays [N,3] x triangles [T,3,3] -> (t [N] inf=miss, tri_idx [N]).

    Vectorised over an [N,T] grid in row chunks to bound memory.
    Backface hits count (needed for the parity inside-test)."""
    N, T = o.shape[0], tri.shape[0]
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    t_best = np.full(N, np.inf, np.float32)
    idx_best = np.full(N, -1, np.int64)
    chunk = max(1, int(2e7) // max(T, 1))
    for s in range(0, N, chunk):
        oo, dd = o[s:s + chunk], d[s:s + chunk]
        h = np.cross(dd[:, None, :], e2[None])            # [n,T,3]
        a = np.einsum("tj,ntj->nt", e1, h)
        inv = 1.0 / np.where(np.abs(a) < eps, eps, a)
        sv = oo[:, None, :] - v0[None]
        u = np.einsum("ntj,ntj->nt", sv, h) * inv
        q = np.cross(sv, e1[None])
        v = np.einsum("ntj,ntj->nt", dd[:, None, :], q) * inv
        t = np.einsum("tj,ntj->nt", e2, q) * inv
        ok = ((np.abs(a) >= eps) & (u >= -eps) & (v >= -eps)
              & (u + v <= 1 + eps) & (t > 1e-5))
        t = np.where(ok, t, np.inf)
        j = np.argmin(t, axis=1)
        tm = t[np.arange(len(j)), j].astype(np.float32)
        t_best[s:s + chunk] = tm
        idx_best[s:s + chunk] = np.where(np.isfinite(tm), j, -1)
    return t_best, idx_best


def _parity_inside(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Inside test by intersection-count parity along a fixed near-+z ray.

    The direction is jittered off-axis so query points aligned with shared
    edges/vertices of axis-aligned meshes don't double-count both adjacent
    triangles under the inclusive (u>=0, v>=0, u+v<=1) bounds and flip the
    parity."""
    N, T = p.shape[0], tri.shape[0]
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    d = np.array([0.0024671, 0.0017313, 1.0], np.float32)
    d /= np.linalg.norm(d)
    counts = np.zeros(N, np.int64)
    h = np.cross(d, e2)                                    # [T,3]
    a = np.einsum("tj,tj->t", e1, h)
    inv = 1.0 / np.where(np.abs(a) < 1e-9, 1e-9, a)
    chunk = max(1, int(2e7) // max(T, 1))
    for s in range(0, N, chunk):
        sv = p[s:s + chunk, None, :] - v0[None]            # [n,T,3]
        u = np.einsum("ntj,tj->nt", sv, h) * inv[None]
        q = np.cross(sv, e1[None])
        v = np.einsum("ntj,j->nt", q, d) * inv[None]
        t = np.einsum("tj,ntj->nt", e2, q) * inv[None]
        ok = ((np.abs(a)[None] >= 1e-9) & (u >= 0) & (v >= 0)
              & (u + v <= 1) & (t > 1e-7))
        counts[s:s + chunk] = ok.sum(1)
    return counts % 2 == 1


# -------------------------------------------------------------- MeshObject
class MeshObject:
    """Posed triangle mesh, duck-typed to sim.objects.PrimObject.

    world_point = R @ (scale * local_point) + t. `params` keeps the
    PrimObject field layout (scale in slot 0) so `state()` round-trips.
    """

    kind = TYPE_MESH

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 R=None, t=None, scale: float = 1.0, material: int = 0,
                 name: str = ""):
        self.verts0 = np.asarray(vertices, np.float32)
        self.faces = np.asarray(faces, np.int32)
        self.scale = float(scale)
        self.R = (np.eye(3, dtype=np.float32) if R is None
                  else np.asarray(R, np.float32).reshape(3, 3))
        self.t = (np.zeros(3, np.float32) if t is None
                  else np.asarray(t, np.float32).reshape(3))
        self.material = int(material)
        self.name = name or "mesh"
        self.params = np.array([self.scale, 0, 0], np.float32)

        v = self.verts0 * self.scale                       # canonical (scaled)
        self._verts = v
        tri = v[self.faces]                                # [T,3,3]
        self._tri = tri
        cr = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        self._areas = 0.5 * np.linalg.norm(cr, axis=-1)
        self._tri_n = cr / (np.linalg.norm(cr, axis=-1, keepdims=True)
                            + _EPS)
        # cached surface point cloud for the SDF (deterministic)
        self._samples = self._sample_surface(
            2048, np.random.RandomState(12345))
        self._centroid = self._verts.mean(0)

    # -------------------------------------------------------------- helpers
    def _sample_surface(self, n: int, rng) -> np.ndarray:
        w = self._areas / max(self._areas.sum(), _EPS)
        ti = rng.choice(len(self._tri), size=n, p=w)
        r1 = np.sqrt(rng.uniform(0, 1, n)).astype(np.float32)
        r2 = rng.uniform(0, 1, n).astype(np.float32)
        a, b, c = (self._tri[ti, 0], self._tri[ti, 1], self._tri[ti, 2])
        return ((1 - r1)[:, None] * a + (r1 * (1 - r2))[:, None] * b
                + (r1 * r2)[:, None] * c).astype(np.float32)

    def to_local(self, p: np.ndarray) -> np.ndarray:
        return (np.asarray(p, np.float32).reshape(-1, 3) - self.t) @ self.R

    def to_world_dir(self, v: np.ndarray) -> np.ndarray:
        return v @ self.R.T

    # -------------------------------------------------------------- queries
    def sdf(self, points: np.ndarray) -> np.ndarray:
        """Signed distance: unsigned distance to the cached surface samples,
        sign from ray-parity. Accuracy ~ sample spacing; sufficient for the
        harness's contact/settle tolerances (mm-scale)."""
        p = self.to_local(points)
        # chunked min distance to the sample cloud
        d = np.empty(p.shape[0], np.float32)
        chunk = max(1, int(4e7) // max(len(self._samples), 1))
        for s in range(0, p.shape[0], chunk):
            diff = p[s:s + chunk, None, :] - self._samples[None]
            d[s:s + chunk] = np.sqrt((diff * diff).sum(-1)).min(1)
        inside = _parity_inside(p, self._tri)
        return np.where(inside, -d, d).astype(np.float32)

    def intersect(self, origins: np.ndarray, dirs: np.ndarray):
        o = self.to_local(origins.astype(np.float32))
        d = dirs.astype(np.float32) @ self.R
        t, ti = moller_trumbore(o, d, self._tri)
        n = np.zeros((len(o), 3), np.float32)
        hit = ti >= 0
        if hit.any():
            nl = self._tri_n[ti[hit]]
            # orient against the ray
            flip = np.einsum("nj,nj->n", nl, d[hit]) > 0
            nl = np.where(flip[:, None], -nl, nl)
            n[hit] = nl
        return t, self.to_world_dir(n)

    def surface_points(self, n: int = 128,
                       rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState(0)
        return self._sample_surface(n, rng) @ self.R.T + self.t

    # ----------------------------------------------------------------- misc
    @property
    def radius_bound(self) -> float:
        return float(np.linalg.norm(self._verts - self._centroid,
                                    axis=-1).max()
                     + np.linalg.norm(self._centroid))

    @property
    def min_width(self) -> float:
        """Smallest caliper width, approximated by the minimum sample extent
        over a direction sweep (axes + PCA axes + quasi-uniform sphere)."""
        c = self._samples - self._samples.mean(0)
        _, _, vt = np.linalg.svd(c, full_matrices=False)
        rng = np.random.RandomState(7)
        dirs = rng.randn(61, 3)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        dirs = np.concatenate([np.eye(3), vt, dirs], 0)
        proj = c @ dirs.T
        return float((proj.max(0) - proj.min(0)).min())

    @property
    def volume(self) -> float:
        """Signed volume via the divergence theorem (watertight meshes)."""
        a, b, c = self._tri[:, 0], self._tri[:, 1], self._tri[:, 2]
        return float(abs(np.einsum("ij,ij->i", a,
                                   np.cross(b, c)).sum() / 6.0))

    def world_triangles(self) -> np.ndarray:
        """[T,3,3] world-space triangles (for the native BVH tracer)."""
        return (self._tri.reshape(-1, 3) @ self.R.T
                + self.t).reshape(-1, 3, 3).astype(np.float32)

    def state(self) -> dict:
        return {"kind": self.kind, "params": self.params.copy(),
                "R": self.R.copy(), "t": self.t.copy(),
                "material": self.material, "name": self.name,
                "vertices": self.verts0.copy(), "faces": self.faces.copy()}

    @classmethod
    def from_state(cls, s: dict) -> "MeshObject":
        return cls(s["vertices"], s["faces"], s["R"], s["t"],
                   float(s["params"][0]), int(s.get("material", 0)),
                   str(s.get("name", "mesh")))


# ----------------------------------------------------- descriptor replay
# The reference workspace is corner-origin: [0, size]^2 in xy with the table
# surface at z = table_height = finger_depth = 0.05 (ref src/gd/simulation.py
# :72-73 place_table, :110 pose [0.15,0.15,height]; pile xy sampled in
# [size/3, 2size/3] = [0.1, 0.2], packed in [0.08, 0.22]). This repo is
# center-origin with the table at z=0 (sim/simulation.py WORKSPACE_LO/HI), so
# reference coordinates shift by -REF_ORIGIN on load / +REF_ORIGIN on save.
REF_ORIGIN = np.array([0.15, 0.15, 0.05], np.float32)


def load_mesh_pose_list(path: str, asset_root: str = "",
                        scene: str = "pile", ref_origin=REF_ORIGIN):
    """Parse a reference-format scene descriptor npz into replayable entries.

    Matches ref src/gd/simulation.py:
      pile   {i: [scale, quat_xyzw(4), xy(2)]} spawn descriptors or
             {uid: [scale, quat_xyzw(4), trans(3), urdf]} rest poses
             (:168-203; only piles save the 3-vector rest variant)
      packed {i: [scale, angle, x, y, urdf]} spawn descriptors (:211-240 —
             the reference's packed loader consumes only this 5-tuple form)

    Entries come back in dict insertion order — the reference iterates
    `dict.values()` and rest-pose dicts are keyed by body_uid strings, so
    lexicographic key sort would reorder ('10' < '2') and change sequential
    drop/settle outcomes.

    Positions are translated from the reference's corner-origin frame into
    this repo's center-origin frame (see REF_ORIGIN; pass ref_origin=None to
    keep raw coordinates). Returns a list of dicts
    {mesh: MeshObject, drop_t: [3], rest: bool, urdf: str}; `drop_t` z is the
    reference's drop height (table + 0.2) for pile spawn entries, the exact
    rest height for rest-pose entries, and half the object's AABB height is
    applied by the caller for packed placement (ref :245-248).
    """
    off = (np.zeros(3, np.float32) if ref_origin is None
           else np.asarray(ref_origin, np.float32))
    d = np.load(path, allow_pickle=True).item()
    entries = []
    for val in d.values():
        scale = float(val[0])
        rest = False
        if scene == "packed":
            angle, x, y, urdf = float(val[1]), float(val[2]), float(val[3]), \
                str(val[4])
            R = Rotation.from_rotvec([0, 0, angle]).as_matrix()
            drop_t = np.array([x - off[0], y - off[1], 0.0], np.float32)
        else:
            quat = np.asarray(val[1], np.float32)          # (x, y, z, w)
            xy = np.asarray(val[2], np.float32).reshape(-1)
            urdf = str(val[3])
            R = Rotation.from_quat(quat).as_matrix()
            if xy.shape[0] == 3:                           # rest pose variant
                drop_t = xy.astype(np.float32) - off
                rest = True
            else:                                          # ref z = table+0.2
                drop_t = np.array([xy[0] - off[0], xy[1] - off[1], 0.2],
                                  np.float32)
        urdf_path = urdf if os.path.isabs(urdf) else \
            os.path.join(asset_root, urdf)
        mesh_path, mesh_scale = mesh_from_urdf(urdf_path)
        verts, faces = load_obj(mesh_path)
        obj = MeshObject(verts * mesh_scale[None], faces,
                         R=R.astype(np.float32), t=drop_t, scale=scale,
                         name=os.path.basename(urdf_path))
        entries.append({"mesh": obj, "drop_t": drop_t, "rest": rest,
                        "urdf": urdf_path})
    return entries


def save_mesh_pose_list(path: str, entries, scene: str = "pile",
                        ref_origin=REF_ORIGIN):
    """Write a reference-format rest-pose descriptor (inverse of
    load_mesh_pose_list): {i: [scale, quat_xyzw, trans(3), urdf]}, with
    translations shifted back into the reference's corner-origin frame
    (ref src/gd/simulation.py:201-203)."""
    off = (np.zeros(3, np.float32) if ref_origin is None
           else np.asarray(ref_origin, np.float32))
    d = {}
    for i, e in enumerate(entries):
        obj = e["mesh"]
        quat = Rotation.from_matrix(obj.R).as_quat().astype(np.float32)
        d[i] = [np.float32(obj.scale), quat,
                obj.t.astype(np.float32) + off,
                str(e.get("urdf", obj.name))]
    np.save(path, np.array(d, dtype=object), allow_pickle=True)
