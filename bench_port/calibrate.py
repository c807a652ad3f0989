"""The readings that the comparison limits are set from, for one cell, in
one process on the card:

    python3 -m bench_port.calibrate --workload plan-fp32 --seeds 1-12 \
        --control-seeds 101-103 [--faults half_rays,altered --fault-seeds ..]

For each program seed: the cell's set-up as a run makes it, the timed
path driven as a run drives it (each pool scene once for planning; the
checked steps for training), and the comparison with the reference. For
each control seed: the reference in the configuration's control precision
(`control` in its file: TF32 under float32, fp8 under bfloat16) put in the
program's place. For each fault and seed: the program with that fault
planted (`faults.py`). Prints a JSON line a reading and, last, each
number's lower reading (the largest of the program's) and the control's
and each fault's smallest."""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import faults, spec


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def reading(cell, seed, device, what, fault=None):
    drv = cell.driver().Driver(cell, seed, device, False)
    t0 = time.perf_counter()
    if what == "control":
        drv.inputs()
        drv.control_samples(cell.config["control"])
    else:
        drv.setup(fault)
        if hasattr(drv, "sweep"):
            drv.sweep()
        drv.release()
    numbers = drv.check()
    row = {"what": what, "seed": seed, "seconds": time.perf_counter() - t0,
           **numbers}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m bench_port.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    kind = cell.traffic["driver"]
    rows = [reading(cell, s, device, "program") for s in seeds(args.seeds)]
    rows += [reading(cell, s, device, "control")
             for s in seeds(args.control_seeds)]
    for name in filter(None, args.faults.split(",")):
        rows += [reading(cell, s, device, name, faults.FAULTS[kind][name])
                 for s in seeds(args.fault_seeds)]
    summary = {}
    for r in rows:
        for k in r:
            if k in ("what", "seed", "seconds") or isinstance(r[k], str):
                continue
            agg = max if r["what"] == "program" else min
            key = f"{r['what']}:{k}"
            summary[key] = agg(summary.get(key, r[k]), r[k])
    print(json.dumps({"workload": args.workload, "device":
                      torch.cuda.get_device_name(device), **summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
