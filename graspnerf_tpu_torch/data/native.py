"""The native (C++/OpenMP) ray tracer of the synthetic scene generator and
the simulator (graspnerf_tpu/data/native.py), through ctypes: `trace_rays`
(spheres and boxes), `trace_prims` (posed primitives) and `trace_tris`
(triangles through a BVH).

`native/raytrace.cpp` is compiled at first use with g++ and the flags of
`native/build.sh` into `graspnerf_tpu_torch/_build/raytrace-<hash>.so` (the
hash covers the source and the flags, so an edit rebuilds). The committed
`native/lib/libraytrace.so` is never loaded: it was built with
`-march=native` on another machine. Without a compiler `available()` is
False and the generator and the simulator trace with their numpy versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from ..build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "raytrace.cpp")
FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _target() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"raytrace-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the tracer unless its library exists; returns its path.
    Raises with the compiler's output if g++ fails."""
    so = _target()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)   # atomic: a concurrent reader never sees half
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.trace_rays.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int,
                               f32p, f32p, ctypes.c_int, f32p, f32p, i32p]
    lib.trace_rays.restype = None
    lib.trace_prims.argtypes = [f32p, ctypes.c_int, f32p, f32p, ctypes.c_int,
                                ctypes.c_int, f32p, f32p, i32p]
    lib.trace_prims.restype = None
    lib.trace_tris.argtypes = [f32p, i32p, ctypes.c_int, f32p, f32p,
                               ctypes.c_int, f32p, f32p, i32p]
    lib.trace_tris.restype = None
    lib.rt_num_threads.argtypes = []
    lib.rt_num_threads.restype = ctypes.c_int
    # libgomp's, found through the library's own dependencies
    lib.omp_set_num_threads.argtypes = [ctypes.c_int]
    lib.omp_set_num_threads.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def prims_available() -> bool:
    """True when `trace_prims` runs natively (the same library)."""
    return available()


def tris_available() -> bool:
    """True when `trace_tris` runs natively (the same library)."""
    return available()


def num_threads() -> int:
    """The OpenMP threads a trace would use (0 without the tracer)."""
    lib = _load()
    return 0 if lib is None else lib.rt_num_threads()


def set_num_threads(n: int) -> None:
    """OpenMP threads for the traces this thread starts from now on."""
    lib = _load()
    if lib is not None:
        lib.omp_set_num_threads(int(n))


def trace_rays(spheres: np.ndarray, boxes: np.ndarray, origins: np.ndarray,
               dirs: np.ndarray):
    """spheres [ns,4], boxes [nb,6], origins/dirs [n,3] -> (t [n] with inf
    for misses, normals [n,3], ids [n]). Same contract as Scene.trace."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native ray tracer is unavailable")
    origins, dirs, n = _rays(origins, dirs)
    spheres = np.ascontiguousarray(spheres, np.float32).reshape(-1, 4)
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 6)
    t = np.empty(n, np.float32)
    normals = np.empty((n, 3), np.float32)
    ids = np.empty(n, np.int32)
    lib.trace_rays(spheres, len(spheres), boxes, len(boxes), origins, dirs,
                   n, t, normals, ids)
    return np.where(t >= 1e29, np.inf, t), normals, ids


def _rays(origins: np.ndarray, dirs: np.ndarray):
    origins = np.ascontiguousarray(origins, np.float32)
    dirs = np.ascontiguousarray(dirs, np.float32)
    n = origins.shape[0]
    if origins.shape != (n, 3) or dirs.shape != (n, 3):
        raise ValueError(f"origins {origins.shape} / dirs {dirs.shape}: "
                         f"expected ({n}, 3)")
    return origins, dirs, n


def trace_prims(prims: np.ndarray, origins: np.ndarray, dirs: np.ndarray,
                with_table: bool = True):
    """prims [np,16] ([kind, R row-major (9), t (3), params (3)]),
    origins/dirs [n,3] -> (t [n] with inf for misses, normals [n,3], ids [n]
    into prims, -1 for a miss and np for the table). The numpy version is
    sim.objects.PrimScene.trace's per-object intersects."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native ray tracer is unavailable")
    origins, dirs, n = _rays(origins, dirs)
    prims = np.ascontiguousarray(prims, np.float32).reshape(-1, 16)
    t = np.empty(n, np.float32)
    normals = np.empty((n, 3), np.float32)
    ids = np.empty(n, np.int32)
    lib.trace_prims(prims, len(prims), origins, dirs, n,
                    1 if with_table else 0, t, normals, ids)
    return np.where(t >= 1e29, np.inf, t), normals, ids


def trace_tris(tris: np.ndarray, tri_ids: np.ndarray, origins: np.ndarray,
               dirs: np.ndarray):
    """tris [nt,3,3] world-space triangles, tri_ids [nt] the object id of
    each, origins/dirs [n,3] -> (t [n] with inf for misses, normals [n,3],
    ids [n]), through a BVH. The numpy version is sim.mesh.moller_trumbore."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native ray tracer is unavailable")
    origins, dirs, n = _rays(origins, dirs)
    tris = np.ascontiguousarray(tris, np.float32).reshape(-1, 9)
    tri_ids = np.ascontiguousarray(tri_ids, np.int32)
    t = np.empty(n, np.float32)
    normals = np.empty((n, 3), np.float32)
    ids = np.empty(n, np.int32)
    lib.trace_tris(tris, tri_ids, len(tris), origins, dirs, n,
                   t, normals, ids)
    return np.where(t >= 1e29, np.inf, t), normals, ids
