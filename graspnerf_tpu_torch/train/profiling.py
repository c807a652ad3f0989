"""Throughput accounting (graspnerf_tpu/train/profiling.py): `rays_per_step`,
the ray evaluations of one renderer pass. The profiler's trace helper is
`tracing.trace`, which `train` exports as `trace`."""
from __future__ import annotations


def rays_per_step(n_rays: int, coarse: int = 40, fine: int = 40,
                  hierarchical: bool = True) -> int:
    """Ray-evaluation count of one renderer pass (for rays/s accounting)."""
    return n_rays * ((coarse + fine) if hierarchical else coarse)
