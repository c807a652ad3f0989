"""The benchmark's spans around the program's layers.

`Spans.wrap(name, fn)` returns fn with a span around each call: a pair of
CUDA events on the current stream (host clock stamps on the CPU), read
after the window as milliseconds, and, while `profiling` is set, a
`torch.profiler` range `bench.<name>`. `Spans.mark(name)` opens a span
that the next `Spans.close(name)` ends, for stretches that no single call
covers. Spans are attached to the program's objects for a traced run only
and taken off again by `undo()`."""
from __future__ import annotations

import collections
import functools
import time
from typing import Callable, Dict, List

import torch


class Spans:
    def __init__(self, device: torch.device):
        self.device = device
        self.profiling = False
        self.pairs: Dict[str, List[tuple]] = collections.defaultdict(list)
        self.open: Dict[str, object] = {}
        self._undo: List[Callable[[], None]] = []

    def stamp(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def mark(self, name: str) -> None:
        rng = None
        if self.profiling:
            rng = torch.profiler.record_function("bench." + name)
            rng.__enter__()
        self.open[name] = (self.stamp(), rng)

    def close(self, name: str) -> None:
        a, rng = self.open.pop(name)
        self.pairs[name].append((a, self.stamp()))
        if rng is not None:
            rng.__exit__(None, None, None)

    def wrap(self, name: str, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def spanned(*args, **kw):
            a = self.stamp()
            if self.profiling:
                with torch.profiler.record_function("bench." + name):
                    out = fn(*args, **kw)
            else:
                out = fn(*args, **kw)
            self.pairs[name].append((a, self.stamp()))
            return out
        return spanned

    def attach(self, owner, attr: str, name: str) -> None:
        """owner.attr = a spanned owner.attr, until undo()."""
        self.patch(owner, attr, self.wrap(name, getattr(owner, attr)))

    def patch(self, owner, attr: str, new) -> None:
        """owner.attr = new, until undo()."""
        had = attr in vars(owner)
        old = getattr(owner, attr)
        setattr(owner, attr, new)

        def restore():
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._undo.append(restore)

    def undo(self) -> None:
        while self._undo:
            self._undo.pop()()

    def ms(self) -> Dict[str, List[float]]:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return {k: [a.elapsed_time(b) for a, b in v]
                    for k, v in self.pairs.items()}
        return {k: [1e3 * (b - a) for a, b in v]
                for k, v in self.pairs.items()}
