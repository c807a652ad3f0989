"""Cells, configurations, mixes and metrics are found by the names in
BENCHMARK.json; a new one is new files and entries, no edit."""
import json
import os
import shutil

import pytest
import torch

from bench_port import run, spec
from bench_port.tests.tiny import SEED, full_cell, tiny_cell

WORKLOADS = ("plan-fp32",)


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_cell_resolves(name):
    cell = spec.cell(name)
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    assert cell.config["name"] == entry["config"]
    assert cell.chips == 1
    assert cell.driver().Driver
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end:
        assert cell.reader("end_to_end", m["name"]).read
    for m in cell.per_layer:
        assert cell.reader("layer_metrics", m["name"]).read
    names = ({"tsdf", "qual", "rot", "width", "cands"}
             if name.startswith("plan") else {"loss", "grad", "change"})
    assert cell.limits and set(cell.limits) <= names


@pytest.mark.parametrize("name", ["plan-bf16", "train-fp32"])
def test_kept_cells_resolve_from_files(name):
    cell = full_cell(name)
    assert cell.driver().Driver and cell.limits
    assert cell.config["name"].startswith("graspnerf-")


def test_benchmark_json_contract():
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))


def test_a_new_cell_is_new_files(tmp_path):
    """A configuration, a mix, a limits file and a per-layer metric added
    as files and entries in a copy of the benchmark run a cell."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "bench_port",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    conf = spec.load_json(os.path.join(spec.HERE, "configs",
                                       "graspnerf-fp32.json"))
    conf["name"] = "dummy-fp32"
    (root / "bench_port/configs/dummy-fp32.json").write_text(json.dumps(conf))
    mix = spec.load_json(os.path.join(spec.HERE, "traffic",
                                      "plan_closed_loop.json"))
    mix["scenes"] = 2
    (root / "bench_port/traffic/dummy_mix.json").write_text(json.dumps(mix))
    (root / "bench_port/limits/dummy-plan.json").write_text(json.dumps(
        {"tsdf": 1e-3, "qual": 1e-3, "rot": 1e-3, "width": 1e-3, "cands": 1e-3}))
    (root / "bench_port/layer_metrics/calls_seen.dummy.py").write_text(
        '"""Calls in the window."""\n\n\ndef read(rec):\n    return rec.calls\n')
    bench["configs"].append({"name": "dummy-fp32", "source": "a test",
                             "file": "bench_port/configs/dummy-fp32.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-plan", "config": "dummy-fp32",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "calls_seen.dummy", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "Planner", "moves": "setup_s",
                               "workloads": ["dummy-plan"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny_cell("dummy-plan", str(root))
    assert cell.config["name"] == "dummy-fp32"
    assert [m["name"] for m in cell.per_layer] == ["calls_seen.dummy"]
    out = run.execute(cell, SEED, 0.2, True, torch.device("cpu"))
    assert out["metrics"]["calls_seen.dummy"]["value"] == out["attempted"]
    assert out["correct"]
