"""What a cell is, read from BENCHMARK.json and the files it names.

A workload names a configuration (`configs/<config>.json`, through
BENCHMARK.json's `configs`) and a traffic mix (`traffic/<traffic>.json`);
the mix names its driver (`drivers/<driver>.py`), the code that runs that
kind of work. The cell's comparison limits are `limits/<workload>.json`.
Its metrics are BENCHMARK.json's entries that list it (or list no cells):
each end-to-end metric is read by `end_to_end/<name>.py`, each per-layer
metric by `layer_metrics/<name>.py`. Nothing here knows a cell, a
configuration or a metric by name, so a new one is a new file and a new
entry."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str) -> ModuleType:
    """A module from its file, whatever characters its name has."""
    name = "bench_port._file_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def work(kernel: str) -> ModuleType:
    """The operations-and-bytes count of kernel `kernel` (`work/`)."""
    return load_module(os.path.join(HERE, "work", kernel + ".py"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str = ROOT

    def reader(self, kind: str, name: str) -> ModuleType:
        """The module that reads metric `name` (`end_to_end/` or
        `layer_metrics/`)."""
        return load_module(os.path.join(self.root, "bench_port", kind,
                                        name + ".py"))

    def driver(self) -> ModuleType:
        return importlib.import_module("bench_port.drivers."
                                       + self.traffic["driver"])


def _applies(metric: dict, cell: str, reported) -> bool:
    """Whether `cell` reports `metric`: the cells it lists; without a list,
    every cell (an end-to-end metric, reported None) or every cell that
    reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def cell(workload: str, root: str = ROOT) -> Cell:
    """The cell `workload` of the BENCHMARK.json at `root`."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return make_cell(workload, os.path.join(root, conf["file"]),
                     entry["traffic"], entry["chips"], bench, root)


def make_cell(workload: str, config_file: str, traffic: str, chips: int,
              bench: dict, root: str = ROOT) -> Cell:
    """A cell from its files: the configuration, `traffic/<traffic>.json`
    and `limits/<workload>.json`, with the metrics of `bench` that list
    it."""
    bench_dir = os.path.join(root, "bench_port")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, None)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, workload, reported)]
    return Cell(workload, chips, load_json(config_file),
                load_json(os.path.join(bench_dir, "traffic",
                                       traffic + ".json")),
                load_json(os.path.join(bench_dir, "limits",
                                       workload + ".json")),
                e2e, layer, root)
