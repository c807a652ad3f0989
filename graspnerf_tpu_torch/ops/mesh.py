"""Surface extraction and mesh/visualization utilities
(graspnerf_tpu/ops/mesh.py:43-142), a numpy copy: importing the JAX package
imports jax.

Replaces the reference's Open3D/plyfile-based debug tooling
(ref: src/nr/utils/draw_utils.py:284-383,408 -- marching-cubes surface from
the predicted volume, gripper markers, PLY export) with self-contained numpy:

  - `marching_tetrahedra`: vectorized iso-surface extraction (6 tetrahedra per
    cell -- simpler tables than marching cubes, watertight, same use case)
  - `save_ply` / ASCII PLY writer (no plyfile dependency)
  - `gripper_lines`: the classic two-finger gripper wireframe at a grasp pose

A volume on the card (the planner's) comes to the host first:
`volume_to_mesh(vol.cpu().numpy())`.
"""
from __future__ import annotations

import numpy as np

# vertex offsets of a unit cell
_CUBE = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int64)
# 6-tetrahedra decomposition of the cube (indices into _CUBE)
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int64)
# for each of the 16 sign cases: the tet-edge pairs forming 0, 1 or 2 tris
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                      np.int64)
_CASES = {
    0b0001: [(0, 1, 2)],
    0b0010: [(0, 3, 4)],
    0b0100: [(1, 5, 3)],
    0b1000: [(2, 4, 5)],
    0b0011: [(1, 2, 4), (1, 4, 3)],
    0b0101: [(0, 3, 5), (0, 5, 2)],
    0b1001: [(0, 1, 5), (0, 5, 4)],
    0b0110: [(0, 1, 5), (0, 5, 4)],
    0b1010: [(0, 3, 5), (0, 5, 2)],
    0b1100: [(1, 2, 4), (1, 4, 3)],
    0b0111: [(2, 4, 5)],
    0b1011: [(1, 5, 3)],
    0b1101: [(0, 3, 4)],
    0b1110: [(0, 1, 2)],
}


def marching_tetrahedra(volume: np.ndarray, level: float = 0.0,
                        spacing: float = 1.0, origin=(0.0, 0.0, 0.0)):
    """Extract the `level` iso-surface of a [X,Y,Z] scalar field.

    Returns (verts [n,3] float32 in metric coords, faces [m,3] int32).
    Vectorized over all cells; interpolation is linear along tet edges.
    """
    vol = np.asarray(volume, np.float32)
    X, Y, Z = vol.shape
    cx, cy, cz = np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                             np.arange(Z - 1), indexing="ij")
    cells = np.stack([cx, cy, cz], -1).reshape(-1, 3)  # [C,3]
    corners = cells[:, None, :] + _CUBE[None]          # [C,8,3]
    vals = vol[corners[..., 0], corners[..., 1], corners[..., 2]]  # [C,8]

    verts_out, faces_out = [], []
    base = 0
    for tet in _TETS:
        tv = vals[:, tet]                  # [C,4]
        tp = corners[:, tet].astype(np.float32)  # [C,4,3]
        inside = tv < level                # [C,4]
        case = (inside * np.array([1, 2, 4, 8])).sum(-1)
        for c, tris in _CASES.items():
            sel = np.flatnonzero(case == c)
            if len(sel) == 0:
                continue
            for tri in tris:
                pts = []
                for e in tri:
                    a, b = _TET_EDGES[e]
                    va, vb = tv[sel, a], tv[sel, b]
                    t = (level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12,
                                                vb - va)
                    t = np.clip(t, 0.0, 1.0)[:, None]
                    pts.append(tp[sel, a] * (1 - t) + tp[sel, b] * t)
                tri_pts = np.stack(pts, 1)  # [n,3,3]
                n = len(sel)
                verts_out.append(tri_pts.reshape(-1, 3))
                faces_out.append(base + np.arange(3 * n).reshape(n, 3))
                base += 3 * n
    if not verts_out:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    verts = np.concatenate(verts_out) * spacing + np.asarray(origin,
                                                             np.float32)
    faces = np.concatenate(faces_out).astype(np.int32)
    return verts.astype(np.float32), faces


def dedupe_mesh(verts: np.ndarray, faces: np.ndarray, decimals: int = 6):
    """Merge coincident vertices (marching_tetrahedra emits per-triangle)."""
    key = np.round(verts, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    return uniq.astype(np.float32), inv[faces].astype(np.int32)


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray,
             colors: np.ndarray | None = None):
    """ASCII PLY writer (replaces the plyfile dependency)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            line = f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"
            if colors is not None:
                c = (np.clip(colors[i], 0, 1) * 255).astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def gripper_lines(pose_matrix: np.ndarray, width: float = 0.08,
                  depth: float = 0.05):
    """Two-finger gripper wireframe at a 4x4 grasp pose → [n,2,3] segments
    (ref draw_utils.py:284-353 gripper overlay)."""
    w2, d = width / 2, depth
    pts = np.array([
        [0, 0, -d], [0, 0, 0],            # approach stem
        [-w2, 0, 0], [w2, 0, 0],          # palm bar
        [-w2, 0, 0], [-w2, 0, d],         # left finger
        [w2, 0, 0], [w2, 0, d],           # right finger
    ], np.float64).reshape(-1, 2, 3)
    R, t = pose_matrix[:3, :3], pose_matrix[:3, 3]
    return (pts @ R.T + t).astype(np.float32)


def volume_to_mesh(tsdf: np.ndarray, voxel_size: float = 0.3 / 40,
                   origin=(0.0, 0.0, 0.0), level: float = 0.0):
    """Predicted TSDF/SDF volume → deduped metric mesh (marching tetrahedra;
    voxel centers at (i+0.5)*voxel)."""
    verts, faces = marching_tetrahedra(tsdf, level)
    if len(verts):
        verts = (verts + 0.5) * voxel_size + np.asarray(origin, np.float32)
    return dedupe_mesh(verts, faces)
