"""The result line's keys, and the runs that must print none."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_port import run, spec
from bench_port.tests.tiny import SEED, full_cell, tiny_cell


@pytest.mark.parametrize("name,trace", [("plan-fp32", 0), ("plan-fp32", 1),
                                        ("train-fp32", 0),
                                        ("train-fp32", 1)])
def test_result_keys(name, trace):
    out = run.execute(tiny_cell(name), SEED, 0.3, bool(trace),
                      torch.device("cpu"))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cell = full_cell(name)
    wanted = cell.per_layer if trace else cell.end_to_end
    got = set(out["metrics"])
    assert got <= {m["name"] for m in wanted}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    elif name in [w["name"] for w in spec.load_json(os.path.join(
            spec.ROOT, "BENCHMARK.json"))["workloads"]]:
        assert "setup_s" in got
    json.dumps(out)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "plan-fp32", "--seed", "1", "--seconds",
                   "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_alone_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no program, no
    result."""
    shutil.copytree(spec.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "-m", "bench_port.run", "--workload",
                        "plan-fp32", "--seed", "3", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
