"""A run with the timed path broken underneath comes out not correct, one
run for each fault the cell can have (one chip: no exchange between chips
to leave out); the same run unbroken comes out correct. The limits are
the cells' own."""
import pytest
import torch

from bench_port import faults, run
from bench_port.tests.tiny import SEED, tiny_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["plan-fp32", "plan-bf16", "train-fp32"])
def test_sound_run_is_correct(name):
    assert run.execute(tiny_cell(name), SEED, 0.2, False, CPU)["correct"]


@pytest.mark.parametrize("name,fault", [
    ("plan-fp32", "stale"), ("plan-fp32", "half_views"),
    ("plan-fp32", "altered"), ("plan-bf16", "stale"),
    ("plan-bf16", "half_views"), ("plan-bf16", "altered"),
    ("train-fp32", "unchanged"),
    ("train-fp32", "half_rays"), ("train-fp32", "altered")])
def test_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    plant = faults.FAULTS[cell.traffic["driver"]][fault]
    out = run.execute(cell, SEED, 0.2, False, CPU, fault=plant)
    assert out["correct"] is False, out["checks"]
