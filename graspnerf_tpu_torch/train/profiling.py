"""Tracing and throughput utilities (graspnerf_tpu/train/profiling.py).

- `ThroughputMeter`: rays/s, TSDF-queries/s, steps/s with EMA smoothing.
- `trace(dir)`: a torch.profiler trace of the CPU and the card around a
  block, written as a Chrome trace (`chrome://tracing`, Perfetto).
- `timed`: host-side span timer, the reference's planning_time logging.
- `rays_per_step`: ray evaluations of one renderer pass.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


class ThroughputMeter:
    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.rates: Dict[str, float] = {}
        self._t: Dict[str, float] = {}

    def start(self, name: str):
        self._t[name] = time.perf_counter()

    def stop(self, name: str, units: float) -> float:
        """Record `units` work items since start(name); returns the
        smoothed units/s."""
        dt = time.perf_counter() - self._t.pop(name)
        rate = units / max(dt, 1e-9)
        prev = self.rates.get(name)
        self.rates[name] = rate if prev is None else (
            self.ema * prev + (1 - self.ema) * rate)
        return self.rates[name]

    def summary(self) -> Dict[str, float]:
        return dict(self.rates)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block on the CPU (and the card, when there is one) and
    write `<log_dir>/trace.json`."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed(record: Dict[str, float], key: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record[key] = time.perf_counter() - t0


def rays_per_step(n_rays: int, coarse: int = 40, fine: int = 40,
                  hierarchical: bool = True) -> int:
    """Ray-evaluation count of one renderer pass (for rays/s accounting)."""
    return n_rays * ((coarse + fine) if hierarchical else coarse)
