"""The program's own spans and counters (`graspnerf_tpu_torch/tracing.py`),
read after a traced run. The program records spans only while the profiler
records, so its store holds the profiled segment's calls alone; per-call
numbers divide by the segment's `plan` roots. Each reader returns None
where the program has no tracing module (a checkout older than it) or
recorded no `plan`, and the run leaves the metric out."""
from __future__ import annotations

import importlib
from typing import Iterable, Optional

MODULE = "graspnerf_tpu_torch.tracing"
ROOT = "plan"


def tracing():
    """The program's tracing module, or None where it has none."""
    try:
        return importlib.import_module(MODULE)
    except ModuleNotFoundError as e:
        if e.name != MODULE:
            raise
        return None


def _roots(t):
    return {r.id for r in t.records() if r.parent is None and r.name == ROOT}


def span_ms_per_call(names: Iterable[str]) -> Optional[float]:
    """Host ms a planning call in the spans `names`, summed."""
    t = tracing()
    roots = _roots(t) if t else None
    if not roots:
        return None
    names = set(names)
    return sum(r.ms for r in t.records()
               if r.name in names and r.root in roots) / len(roots)


def counter_per_call(name: str) -> Optional[float]:
    """Counter `name` over the planning calls recorded."""
    t = tracing()
    roots = _roots(t) if t else None
    if not roots:
        return None
    return t.counters()[name] / len(roots)


def counter(name: str) -> Optional[float]:
    """Counter `name`, the process's total."""
    t = tracing()
    return None if t is None else t.counters()[name]
