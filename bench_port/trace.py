"""The profiled segment of a traced run and what is read from it.

After the measured window a traced run profiles a few more calls or steps
with `torch.profiler` (CPU and CUDA activity), inside one range named
`bench.segment`, with the benchmark's own ranges (`bench.<span>`) around
each call and the program's layers. The Chrome trace goes to the run's
temporary directory and is read back here:

- the segment's window: the `bench.segment` range on the host clock;
- busy seconds: the union of the device's kernels, memsets and copies
  within it; the idle share follows;
- lost events: runtime kernel launches and copies whose device record is
  missing (by correlation id; a memset of no bytes leaves none, so memsets
  are not counted). A segment that lost any is not read for
  rooflines, idle share or launches;
- per kernel of `work/`: its device records (by name; a memset
  immediately before its first kernel where the module says so), their
  seconds, and the program's own launch counter over the segment;
- the breakdown: device seconds by operation name, and idle seconds by
  the benchmark range and innermost host operation open at each gap.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
import json
import os
import tempfile
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
LAUNCH_WORDS = ("Launch", "Memcpy")    # a memset of no bytes has no record
TOP = 10


@dataclasses.dataclass
class Segment:
    calls: int
    window_s: float
    busy_s: float
    device_events: int
    lost: Dict[str, int]       # launch calls without a device record
    kernel_s: Dict[str, float]
    kernel_launches: Dict[str, int]
    counters: Dict[str, int]
    breakdown: dict

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    @property
    def launches_per_call(self) -> float:
        return self.device_events / self.calls


def counters(kernels) -> Dict[str, int]:
    """The program's launch counter of each kernel's wrapper."""
    out = {}
    for name, mod in kernels.items():
        module, fn = mod.COUNTER
        out[name] = int(getattr(importlib.import_module(module), fn).launches)
    return out


def profile(fn, calls: int, kernels, device):
    """Runs fn(i) for i < calls under the profiler inside `bench.segment`;
    returns its Segment."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = counters(kernels)
    with torch_profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.segment"):
            for i in range(calls):
                with torch.profiler.record_function("bench.call"):
                    fn(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    after = counters(kernels)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, calls, kernels,
                     {k: after[k] - before[k] for k in kernels})


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    return name.split("(")[0].replace("void ", "")[:80]


def summarize(events: List[dict], calls: int, kernels,
              counted: Dict[str, int]) -> Segment:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    seg = [e for e in xs if e.get("name") == "bench.segment"
           and e.get("cat") == "user_annotation"]
    if not seg:
        raise RuntimeError("the trace has no bench.segment range")
    t0, t1 = seg[0]["ts"], seg[0]["ts"] + seg[0]["dur"]
    dev = sorted((e for e in xs if e.get("cat") in DEVICE_CATS
                  and t0 <= e["ts"] <= t1), key=lambda e: e["ts"])
    corr = {e.get("args", {}).get("correlation") for e in dev}
    lost = collections.Counter(
        e["name"] for e in xs if e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver")
        and t0 <= e["ts"] <= t1
        and any(w in e["name"] for w in LAUNCH_WORDS)
        and e.get("args", {}).get("correlation") not in corr)
    busy = _merge([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in dev])
    busy_us = sum(b - a for a, b in busy)

    kernel_s, launches = {}, {}
    for name, mod in kernels.items():
        hits = [i for i, e in enumerate(dev)
                if e["cat"] == "kernel" and mod.PATTERN.search(e["name"])]
        if mod.LEADING_MEMSET:
            hits += [i - 1 for i in hits
                     if i > 0 and dev[i - 1]["cat"] == "gpu_memset"]
        kernel_s[name] = sum(dev[i]["dur"] for i in set(hits)) * 1e-6
        launches[name] = len(set(hits))

    by_op = collections.Counter()
    for e in dev:
        by_op[_short(e["name"])] += e["dur"] * 1e-6
    return Segment(
        calls=calls, window_s=(t1 - t0) * 1e-6, busy_s=busy_us * 1e-6,
        device_events=len(dev), lost=dict(lost), kernel_s=kernel_s,
        kernel_launches=launches, counters=counted,
        breakdown={"device_ops": [[k, v] for k, v in by_op.most_common(TOP)],
                   "idle_gaps": _idle_by_host(xs, busy, t0, t1)})


def _idle_by_host(xs, busy, t0, t1):
    """Idle device seconds by what the host's main thread had open at each
    gap's start: the innermost benchmark range and host operation."""
    seg = next(e for e in xs if e.get("name") == "bench.segment")
    host = sorted((e for e in xs if e.get("tid") == seg.get("tid")
                   and e.get("cat") in ("user_annotation", "cpu_op")),
                  key=lambda e: (e["ts"], -e["dur"]))
    gaps, at = [], t0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < t1:
        gaps.append((at, t1))
    idle = collections.Counter()
    stack, k = [], 0
    for a, b in gaps:             # in time order: one sweep of the host
        while k < len(host) and host[k]["ts"] <= a:
            stack.append(host[k])
            k += 1
        stack = [e for e in stack if e["ts"] + e["dur"] >= a]
        span = next((e["name"] for e in reversed(stack)
                     if e["cat"] == "user_annotation"), "bench")
        op = next((e["name"] for e in reversed(stack)
                   if e["cat"] == "cpu_op"), None)
        idle[span + (":" + op if op else "")] += (b - a) * 1e-6
    return [[k, v] for k, v in idle.most_common(TOP)]
