"""Build and load the CUDA kernels of csrc/.

Each `csrc/<name>.cu` has a plain C interface. It is compiled at first use by
`nvcc ... -shared` into `graspnerf_tpu_torch/_build/<name>-<hash>.so` (the
hash covers the source and the flags, so an edit rebuilds) and loaded with
ctypes. Nothing here runs at import time, so the package imports on a machine
with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, List

from . import tracing

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"]
# Per-source flags. The gather reproduces the plain version's rounding op by
# op, so it must not contract a*b+c into FMAs.
EXTRA_FLAGS = {"epipolar_gather": ["-fmad=false"]}
KERNELS = ("view_fuse", "view_fuse_bf16", "epipolar_gather")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(name: str) -> List[str]:
    return ARCH_FLAGS + COMMON_FLAGS + EXTRA_FLAGS.get(name, [])


def _target(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library, all nvcc processes at once. Returns
    {name: ptxas report} for the sources compiled by this call; raises with
    the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        so = _target(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path()] + _flags(name) + [
            "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    reports, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode})\n{out}")
            continue
        os.replace(tmp, so)   # atomic: a reader never sees half a library
        tracing.COUNTERS["kernels_built"] += 1
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        t0 = time.perf_counter()
        so = _target(name)
        if not os.path.exists(so):
            build([name])
        lib = ctypes.CDLL(so)
        _loaded[name] = lib
        tracing.COUNTERS["kernel_load_s"] += time.perf_counter() - t0
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
