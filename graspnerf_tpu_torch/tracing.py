"""The port's spans and counters.

Spans. `span(name)` is a context manager around one stretch of a layer's
work. It records only while `torch.profiler` records (the profiler's own
switch, `torch.autograd.profiler._is_profiler_enabled`); otherwise entering
and leaving it checks one attribute and allocates nothing. A span object
holds no state of its own, so callers make each once, at import, and
reuse it. While recording, a span

- opens a `torch.profiler.record_function("graspnerf.<name>")` range, so
  that it sits in the profiler's trace on the trace's own clock, and
- appends a `Record` to the store: its name, its parent record, the id of
  its root (every span under one root shares it) and its host start and
  end (`time.perf_counter_ns`, around its own range).

A stage that replays a CUDA graph (`graphs.py`) runs no Python of its body:
its outer span (`encode`, `volume`, `head`) opens around the replay, and
the spans inside the body record only on eager calls.

The store grows only while recording; `records()` reads it, `reset()`
empties it and zeroes the counters that count per recorded call,
`self_ms(record)` is a record's duration less what its children cover.
Spans nest on one stack: record from one thread at a time.

Counters (`counters()`), plain process-wide numbers:

- per recorded call, counted only inside a recording root span (on the
  planning path, `plan`), so that a counter over the recorded roots reads
  a call's share:
  - `host_syncs`: synchronising CUDA calls, counted from PyTorch's sync
    debug mode (`torch.cuda.set_sync_debug_mode("warn")`), turned on only
    there and its warnings counted without being shown; 0 on the CPU;
  - `graph_replays`: CUDA graph replays of the stages (`graphs.py`);
- counted always, one-off costs of set-up:
  - `kernels_built`: libraries that `build.build` compiled in this process;
  - `kernel_load_s`: seconds in `build.load` (a library's build or load);
  - `model_load_s`: seconds in `models.load_graspnerf`;
  - `graph_captures`: CUDA graphs captured (`graphs.py`);
  - `conv_search_calls`: calls of the encode's body on a card with
    autograd off (eager calls and captures, not replays), each run under
    cuDNN's algorithm search (`models/renderer.py`
    `searched_convolutions`); only a call that meets a convolution shape
    first times its algorithms;
- each kernel wrapper's launch counters (`<wrapper>.launches`,
  `<wrapper>.bf16_launches`), read where they live; a graph replay adds
  the launches its capture counted (`launch_counts`, `add_launches`).

`trace(log_dir)` profiles a block and writes its Chrome trace, spans
included.
"""
from __future__ import annotations

import contextlib
import importlib
import itertools
import os
import time
import warnings
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

SYNC_WARNING = "called a synchronizing CUDA operation"
# (module, wrapper) of each kernel wrapper with launch counters
WRAPPERS = (("ops.view_fuse", "view_fuse"),
            ("ops.epipolar_gather", "epipolar_gather"),
            ("ops.epipolar_gather", "epipolar_gather_backward"),
            ("ops.epipolar_gather", "epipolar_gather_backward_xy"))

COUNTERS: Dict[str, float] = {"host_syncs": 0, "graph_replays": 0,
                              "kernels_built": 0, "kernel_load_s": 0.0,
                              "model_load_s": 0.0, "graph_captures": 0,
                              "conv_search_calls": 0}
PER_CALL = ("host_syncs", "graph_replays")


class Record:
    """One recorded span; times in ns of `time.perf_counter_ns`."""
    __slots__ = ("id", "name", "parent", "root", "start_ns", "end_ns",
                 "child_ns")

    def __init__(self, id: int, name: str, parent: Optional["Record"],
                 start_ns: int):
        self.id, self.name, self.parent = id, name, parent
        self.root = id if parent is None else parent.root
        self.start_ns = self.end_ns = start_ns
        self.child_ns = 0          # what its closed children cover

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


_records: List[Record] = []
_open: list = []           # (span, record, profiler range, sync counting)
_ids = itertools.count()


class span:
    """`with span(name):` records the block while the profiler records."""
    __slots__ = ("name", "label")

    def __init__(self, name: str):
        self.name = name
        self.label = "graspnerf." + name

    def __enter__(self):
        if not _profiler._is_profiler_enabled:
            return self
        start = time.perf_counter_ns()
        rng = torch.profiler.record_function(self.label)
        rng.__enter__()
        parent = _open[-1][1] if _open else None
        rec = Record(next(_ids), self.name, parent, start)
        _records.append(rec)
        _open.append((self, rec, rng,
                      _count_syncs() if parent is None else None))
        return self

    def __exit__(self, *exc):
        if not _open or _open[-1][0] is not self:
            return False
        _, rec, rng, syncs = _open.pop()
        if syncs is not None:
            _counted_syncs(*syncs)
        rng.__exit__(None, None, None)
        rec.end_ns = time.perf_counter_ns()
        if rec.parent is not None:
            rec.parent.child_ns += rec.end_ns - rec.start_ns
        return False


def _count_syncs():
    """On a card: sync debug mode at "warn", its warnings counted in place
    of being shown, until `_counted_syncs`. None on the CPU."""
    if not torch.cuda.is_initialized():
        return None
    catch = warnings.catch_warnings()
    catch.__enter__()
    warnings.filterwarnings("always", message=SYNC_WARNING)
    warnings.showwarning = _count_or_show(warnings.showwarning)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    return catch, mode


def _count_or_show(show):
    """A `warnings.showwarning` that counts the sync warnings and hands
    the others to `show`."""
    def count(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            COUNTERS["host_syncs"] += 1
        else:
            show(message, category, filename, lineno, file, line)
    return count


def _counted_syncs(catch, mode) -> None:
    torch.cuda.set_sync_debug_mode(mode)
    catch.__exit__(None, None, None)


def count_recorded(name: str) -> None:
    """Counts one `name` (a `PER_CALL` counter) if a root span records."""
    if _open:
        COUNTERS[name] += 1


def records() -> List[Record]:
    """The recorded spans, in the order they opened."""
    return list(_records)


def reset() -> None:
    """Empties the store and zeroes the `PER_CALL` counters, which, like
    the store, grow only while recording."""
    _records.clear()
    for name in PER_CALL:
        COUNTERS[name] = 0


def self_ms(record: Record) -> float:
    """`record`'s duration less the part its children cover."""
    return (record.end_ns - record.start_ns - record.child_ns) * 1e-6


def counters() -> Dict[str, float]:
    """A snapshot of the counters and of the kernel wrappers' launches."""
    return {**COUNTERS, **launch_counts()}


def _launch_counters():
    """(name, wrapper, attribute) of each kernel wrapper's launch counter."""
    for module, name in WRAPPERS:
        fn = getattr(importlib.import_module(f"{__package__}.{module}"), name)
        for attr in ("launches", "bf16_launches"):
            if hasattr(fn, attr):
                yield f"{name}.{attr}", fn, attr


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters, by `<wrapper>.<counter>`."""
    return {key: getattr(fn, attr) for key, fn, attr in _launch_counters()}


def add_launches(counts: Dict[str, int]) -> None:
    """Adds `counts` (as `launch_counts` names them) to the counters: the
    launches a graph replay makes without calling the wrappers."""
    for key, fn, attr in _launch_counters():
        if counts.get(key):
            setattr(fn, attr, getattr(fn, attr) + counts[key])


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
