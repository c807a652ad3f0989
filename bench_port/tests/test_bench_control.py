"""The control, the reference in the precision below the configuration's
(TF32 under float32, fp8 under bfloat16) put in the program's place, comes
out not correct under the cells' limits: on a card at the cells' sizes
(four scenes a planning pool), and on the CPU at a tiny size."""
import pytest
import torch

from bench_port import judge
from bench_port.tests.tiny import SEED, full_cell, tiny_cell


def control_verdict(cell, seed, device):
    drv = cell.driver().Driver(cell, seed, device, False)
    drv.inputs()
    drv.control_samples(cell.config["control"])
    return judge.verdict(drv.check(), cell.limits)


@pytest.mark.parametrize("name", ["plan-fp32", "plan-bf16", "train-fp32"])
def test_control_fails_on_cpu(name):
    correct, rows = control_verdict(tiny_cell(name), SEED,
                                    torch.device("cpu"))
    assert not correct, rows


@pytest.mark.card
@pytest.mark.parametrize("name", ["plan-fp32", "plan-bf16", "train-fp32"])
def test_control_fails_on_card(name, card):
    cell = full_cell(name)
    cell.traffic.update({k: v for k, v in {"scenes": 4}.items()
                         if k in cell.traffic})
    for seed in (11, 12, 13):
        correct, rows = control_verdict(cell, seed, card)
        assert not correct, rows
