"""CUDA graphs of the planning call's three stages.

Eagerly, a planning call issues ~830 device operations one by one from the
host, and the card waits on the host between them. Each stage body
(`NeuralRayRenderer.encode_views`, `NeuralRayRenderer.sample_volume`,
`GraspNeRFPlanner.detect`) hands itself to `run`, which calls it eagerly or
replays a CUDA graph of it: one launch in place of the stage's hundreds,
the same kernels in the same order. `run` follows PyTorch's recipe
(`torch.cuda.graphs`): warm up (an eager call does every lazy set-up:
kernel builds, cuDNN plans, the cached constants and weight packs),
capture on a side stream, then on each call copy the inputs into the
graph's static input tensors and replay. Every call launches each kernel
once, as an eager call does.

- When (`engages`): only where the stage can see from its own input that
  the call can be captured: its tensors on a CUDA device, autograd off,
  and no rank split (`space`). Training, the CPU and a space-split render
  run eagerly, unchanged.
- Key (`call_key`): a graph is replayed only while the call matches its
  capture: the inputs' structure, their tensors' shapes, dtypes and
  devices, the stage's own settings (`extra`), and the storage and version
  counter (`_version`) of every parameter of the modules the stage reads.
  A call with another key runs eagerly. The second call in a row with one
  key captures the stage, after the first has warmed it up, and replays
  the graph for its own outputs; traffic whose key changes on every call
  never pays for a capture it cannot replay. One graph a stage and owner.
  Those modules (`_Stage.holders`) keep their parameters alive, so
  whatever lives as long as a parameter does, such as the view fuse's
  weight pack made for those versions, is alive whenever a replay can read
  it.
- Capture: `CUDAGraph.capture_begin` / `capture_end` rather than the
  `torch.cuda.graph` context, which first synchronises and empties the
  allocator's caches: a validation pass between training steps recaptures
  (its parameters' versions moved), and the emptied caches were then
  filled again by `cudaMalloc`. A recapture takes the memory pool and the
  side stream of the graph it replaces, so the stage's blocks are reused
  (on a new stream they were not, and the pools grew by each capture).
- Outputs: a replay hands back clones of the graph's output tensors, never
  the tensors themselves, since a caller may keep a call's outputs across
  later calls.
- Counters (`tracing.py`): a replay adds to the kernel wrappers' launch
  counters the launches its capture counted, and counts `graph_replays`;
  a capture counts `graph_captures`.
"""
from __future__ import annotations

import weakref
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn as nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import tracing

_stages = weakref.WeakKeyDictionary()   # owner -> {stage name: _Stage}


def engages(device: torch.device, grad_enabled: bool, split) -> bool:
    """Whether a call can be captured: on a CUDA device, autograd off, and
    no rank split."""
    return device.type == "cuda" and not grad_enabled and split is None


def tensors_of(leaves) -> List[torch.Tensor]:
    """The tensors among `tree_flatten`'s leaves."""
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def with_tensors(leaves, tensors) -> list:
    """leaves with each tensor replaced, in order, by the next of the
    iterator `tensors`."""
    return [next(tensors) if isinstance(x, torch.Tensor) else x
            for x in leaves]


def call_key(leaves, spec, extra, holders: Sequence[nn.Module]) -> tuple:
    """What a graph's capture must share with a call for the call to replay
    it: the structure `spec` of the call's arguments (`tree_flatten`), its
    leaves other than tensors, its tensors' shapes, dtypes and devices, the
    stage's settings `extra`, and the storage and version of each parameter
    of `holders`."""
    return (spec, extra,
            tuple((x.shape, x.dtype, x.device)
                  if isinstance(x, torch.Tensor) else x for x in leaves),
            tuple((p.data_ptr(), p._version) for m in holders
                  for p in m._parameters.values() if p is not None))


def run(owner, stage: str, fn: Callable, args: tuple,
        modules: Sequence[nn.Module] = (), extra=(), split=None):
    """fn(*args), called eagerly or replayed from its graph. owner: the
    object the stage belongs to, whose graphs live as long as it does;
    modules: those whose parameters fn reads; extra: a hashable of the
    settings fn reads besides; split: the call's rank split, if any."""
    leaves, spec = tree_flatten(args)
    tensors = tensors_of(leaves)
    if not engages(tensors[0].device, torch.is_grad_enabled(), split):
        return fn(*args)
    stages = _stages.setdefault(owner, {})
    st = stages.get(stage)
    if st is None:
        st = stages[stage] = _Stage(modules)
    key = call_key(leaves, spec, extra, st.holders)
    if st.graph is None or st.graph.key != key:
        if key != st.last_key:
            st.last_key = key
            return fn(*args)
        st.graph = _Graph(fn, leaves, spec, key, st.graph)
    return st.graph.replay(tensors)


class _Stage:
    """One owner's stage: the modules that hold the parameters it reads,
    the key of its last eager call, and its graph once captured."""

    def __init__(self, modules: Sequence[nn.Module]):
        self.holders = tuple(m for mod in modules for m in mod.modules()
                             if m._parameters)
        self.last_key: Optional[tuple] = None
        self.graph: Optional[_Graph] = None


class _Graph:
    """A CUDA graph of fn on static copies of a call's input tensors, with
    its static outputs, the launches its capture counted and the side
    stream it was captured on. replaced: the stage's graph that this one
    replaces, if any."""

    def __init__(self, fn: Callable, leaves, spec, key: tuple,
                 replaced: Optional["_Graph"] = None):
        self.key = key
        self.inputs = [t.clone() for t in tensors_of(leaves)]
        args = tree_unflatten(with_tensors(leaves, iter(self.inputs)), spec)
        before = tracing.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(self.inputs[0].device)
        if replaced is None:
            pool, self.side = None, torch.cuda.Stream(self.inputs[0].device)
        else:   # the allocator reuses a pool's blocks on their own stream
            pool, self.side = replaced.graph.pool(), replaced.side
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            self.graph.capture_begin(pool=pool)
            try:
                out = fn(*args)
            finally:
                self.graph.capture_end()
        main.wait_stream(self.side)
        after = tracing.launch_counts()
        self.launches = {k: n - before[k] for k, n in after.items()}
        tracing.add_launches({k: -n for k, n in self.launches.items()})
        self.out_leaves, self.out_spec = tree_flatten(out)
        tracing.COUNTERS["graph_captures"] += 1

    def replay(self, tensors: Sequence[torch.Tensor]):
        for static, t in zip(self.inputs, tensors):
            static.copy_(t)
        self.graph.replay()
        tracing.add_launches(self.launches)
        tracing.count_recorded("graph_replays")
        clones = (t.clone() for t in tensors_of(self.out_leaves))
        return tree_unflatten(with_tensors(self.out_leaves, clones),
                              self.out_spec)
