"""A traced run reports `conv_search_calls.plan`, the program's count of
encode calls under cuDNN's algorithm search; on the CPU the encode never
searches, so it reads the counter as the run found it."""
import torch

from bench_port import run
from bench_port.tests.tiny import SEED, tiny_cell


def test_traced_plan_run_reports_the_search_count():
    from graspnerf_tpu_torch import tracing
    before = tracing.counters()["conv_search_calls"]
    cell = tiny_cell("plan-fp32")
    assert "conv_search_calls.plan" in {m["name"] for m in cell.per_layer}
    out = run.execute(cell, SEED, 0.2, True, torch.device("cpu"))
    assert out["correct"]
    assert out["metrics"]["conv_search_calls.plan"] == {"value": before,
                                                        "unit": "count"}
