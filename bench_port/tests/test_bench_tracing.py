"""A traced run reports the program's own spans and counters
(`program_spans.py`, the `graspnerf_tpu_torch.tracing` store)."""
import torch

from bench_port import run
from bench_port.tests.tiny import SEED, tiny_cell

SPANS = ("upload_ms.plan", "issue_ms.plan", "wait_ms.plan", "grasps_ms.plan")
COUNTERS = ("host_syncs.plan", "kernels_built.plan", "kernel_load_s.plan",
            "model_load_s.plan")


def test_traced_plan_run_reports_the_program_metrics():
    from graspnerf_tpu_torch import tracing
    tracing.reset()
    before = tracing.counters()     # process-wide: other tests' loads too
    cell = tiny_cell("plan-fp32")
    assert set(SPANS + COUNTERS) <= {m["name"] for m in cell.per_layer}
    out = run.execute(cell, SEED, 0.2, True, torch.device("cpu"))
    assert out["correct"]
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    for name in SPANS:
        assert metrics[name] >= 0
    assert metrics["issue_ms.plan"] > metrics["wait_ms.plan"]
    # the CPU: no sync is counted, no kernel built or loaded
    assert metrics["host_syncs.plan"] == 0
    for name in ("kernels_built", "kernel_load_s"):
        assert metrics[name + ".plan"] == before[name]
    assert metrics["model_load_s.plan"] > before["model_load_s"]
    roots = [r for r in tracing.records() if r.parent is None]
    assert {r.name for r in roots} == {"plan"}
    assert len(roots) == cell.traffic["trace_calls"]
