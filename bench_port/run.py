"""One run of one cell of the port's benchmark.

    python3 -m bench_port.run --workload plan-fp32 --seed 7 --seconds 20 \
        --trace 0

Builds or loads the port's kernels, makes the weights and the cell's
inputs from the seed on the card, warms up, measures for `--seconds`,
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1`
`breakdown`, and last `checks`, each compared number beside its limit
(also the last lines of standard error). It exits non-zero without a
result when there is no CUDA card, or fewer than the cell asks for, and
when a module of JAX or of the JAX package is loaded once the window has
closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "graspnerf_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: graspnerf_tpu_torch is not graspnerf_tpu)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t0: float = T0, fault=None) -> dict:
    """Runs `cell` (`spec.Cell`) on `device`; returns the result line's
    object. `fault` (`faults.py`) plants a fault in the program."""
    import torch
    from . import judge
    drv = cell.driver().Driver(cell, seed, device, trace)
    drv.setup(fault)
    rec = drv.record
    rec.setup_s = time.perf_counter() - t0
    drv.window(seconds)
    if trace:
        drv.profile()
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    drv.release()
    numbers = drv.check()
    print("numbers: " + json.dumps(numbers), file=sys.stderr)
    if rec.latencies_s:
        q = sorted(rec.latencies_s)
        print(f"window: {len(q)} calls in {rec.window_s:.3f} s, ms min "
              f"{1e3 * q[0]:.2f} median {1e3 * q[len(q) // 2]:.2f} max "
              f"{1e3 * q[-1]:.2f}; setup {rec.setup_s:.2f} s", file=sys.stderr)
    correct, rows = judge.verdict(numbers, cell.limits)
    kind = "layer_metrics" if trace else "end_to_end"
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(kind, m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit_w"] = power_limit()
    out = {"correct": bool(correct), "attempted": rec.calls,
           "failed": rec.failed, "metrics": metrics, "device": dev}
    if trace and rec.segment is not None:
        seg = rec.segment
        print(f"segment: {seg.calls} calls, {seg.device_events} device "
              f"records, lost {seg.lost}, kernels {seg.kernel_launches}, "
              f"wrapper calls {seg.counters}", file=sys.stderr)
        dev.update(busy_s=seg.busy_s, window_s=seg.window_s)
        out["breakdown"] = seg.breakdown
    out["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                         "limit": lim} for k, v, lim in rows}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m bench_port.run",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from . import spec
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench_port: the cell needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = execute(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print("bench_port: JAX or the JAX package is loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
