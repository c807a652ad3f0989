"""The host data pipeline (graspnerf_tpu/data/prefetch.py) as a
`torch.utils.data.DataLoader` over an `IterableDataset`, and the move of a
batch to the card.

Worker w builds its own dataset as `factory(seed + 1000 * w)` (datasets
carry a RandomState) and yields whole scene batches: `scenes_per_batch`
consecutive samples of its dataset, stacked along a new leading S axis. The
loader hands the workers' batches out in turn (worker 0's first, worker 1's
first, ..., worker 0's second, ...), as tensors, in pinned memory when
asked. With 0 workers the parent process samples `factory(seed)` itself.
The batches travel from the workers as pickled numpy arrays through a pipe,
not as tensors in shared memory: a container's /dev/shm can be smaller than
the batches in flight (~17 MB each at full width).

Workers are started by a fork server, never by "fork": the parent runs the
OpenMP tracer too (validation batches), and GNU libgomp is not fork-safe
once a process has used it, so workers forked from the parent can hang. The
fork server is a fresh process that has run no OpenMP. ("spawn" is safe as
well, but a spawned worker runs the C++ static destructors at exit, and
with this pipeline those could abort it at shutdown: "terminate called
without an active exception".) A worker never touches CUDA. Each worker
gets an equal share of the host's cores for its tracer's OpenMP threads and
for torch, so that the workers together do not oversubscribe the host. A
worker's exception reaches the consumer; a worker that delivers nothing
within `timeout` seconds raises there too.
"""
from __future__ import annotations

import functools
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.data import DataLoader, IterableDataset, get_worker_info

from . import native

PREFETCH_BATCHES = 2   # batches each worker keeps ready


def collate_scenes(samples):
    """Stack a list of per-scene sample trees (dicts of numpy arrays) along
    a new leading axis."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: collate_scenes([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples])


def to_tensors(tree):
    """A tree of numpy arrays as CPU tensors sharing their memory."""
    if isinstance(tree, dict):
        return {k: to_tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def to_device(tree, device):
    """A nested dict of numpy arrays or tensors as tensors on `device`:
    integers as int64, the rest as float32. From pinned memory the copy to
    the card does not block the host."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    t = torch.as_tensor(tree)
    integer = not t.dtype.is_floating_point and t.dtype != torch.bool
    return t.to(device, non_blocking=True).to(
        torch.int64 if integer else torch.float32)


class DatasetFactory:
    """A picklable `factory(seed)`: cls(seed=seed, **kwargs). The workers
    receive it pickled, so it names a class, not a closure."""

    def __init__(self, cls, **kwargs):
        self.cls, self.kwargs = cls, kwargs

    def __call__(self, seed: int):
        return self.cls(seed=seed, **self.kwargs)


class _SceneStream(IterableDataset):
    """Endless scene batches from the calling worker's own dataset."""

    def __init__(self, factory: Callable[[int], object], seed: int,
                 scenes_per_batch: int):
        super().__init__()
        self.factory, self.seed, self.scenes = factory, seed, scenes_per_batch

    def __iter__(self):
        info = get_worker_info()
        ds = self.factory(self.seed + 1000 * (0 if info is None else info.id))
        while True:
            yield collate_scenes([ds.sample() for _ in range(self.scenes)])


def _pin(tree):
    if isinstance(tree, dict):
        return {k: _pin(v) for k, v in tree.items()}
    return tree.pin_memory()


def _init_worker(threads: int, worker_id: int) -> None:
    torch.set_num_threads(threads)
    native.set_num_threads(threads)


def host_cores() -> int:
    """The cores this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


class SceneLoader:
    """Endless collated scene batches ({key: tensor [S, ...]}) from
    `num_workers` worker processes, or from this process when 0.

    factory(seed) -> an object with .sample() -> one scene's tree of numpy
    arrays; it is pickled to the workers (see `DatasetFactory`). `timeout`:
    seconds a worker may take for a batch before `next()` raises.
    `data_wait_s` accumulates the time the consumer blocked in `next()`.
    """

    def __init__(self, factory: Callable[[int], object], num_workers: int = 4,
                 scenes_per_batch: int = 1, seed: int = 0,
                 pin_memory: bool = False, timeout: float = 600.0):
        self.pin_memory = pin_memory
        self.data_wait_s = 0.0
        kw: Dict = {}
        if num_workers > 0:
            native.available()   # builds the tracer here, not in each worker
            threads = max(1, host_cores() // num_workers)
            kw = dict(multiprocessing_context="forkserver", timeout=timeout,
                      prefetch_factor=PREFETCH_BATCHES,
                      worker_init_fn=functools.partial(_init_worker, threads))
        self._loader = DataLoader(
            _SceneStream(factory, seed, scenes_per_batch), batch_size=None,
            num_workers=num_workers, **kw)
        self._it: Optional[object] = iter(self._loader)

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            raise StopIteration
        t0 = time.perf_counter()
        batch = to_tensors(next(self._it))
        if self.pin_memory:
            batch = _pin(batch)
        self.data_wait_s += time.perf_counter() - t0
        return batch

    def pop_data_wait(self) -> float:
        w, self.data_wait_s = self.data_wait_s, 0.0
        return w

    def close(self) -> None:
        """Stop the workers (dropping the iterator shuts them down)."""
        self._it = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
