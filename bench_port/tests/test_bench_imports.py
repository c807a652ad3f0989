"""The harness loads no JAX, flax or JAX package module, and the
reference loads nothing of the port either (names compared whole: the
port's name begins with the JAX package's)."""
import json
import subprocess
import sys

from bench_port import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "graspnerf_tpu")

HARNESS = """
import sys, json, torch
import bench_port.run, bench_port.trace, bench_port.calibrate
from bench_port.tests.tiny import tiny_cell, SEED
out = bench_port.run.execute(tiny_cell("plan-fp32"), SEED, 0.1, False,
                             torch.device("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import sys, json, torch
from bench_port import reference, weights
from bench_port.drivers import common
from bench_port.tests.tiny import tiny_cell
c = tiny_cell("plan-fp32").config
sd = weights.seeded(common.reference_cfg(c), 1, torch.device("cpu"))
ref = reference.build(common.reference_cfg(c), sd, "cpu")
with torch.no_grad():
    ref.plan({"imgs": torch.rand(6, 64, 96, 3), "poses": torch.eye(4)[:3]
              .expand(6, 3, 4), "Ks": torch.eye(3).expand(6, 3, 3),
              "depth_range": torch.tensor([[0.2, 0.8]] * 6),
              "bbox3d_min": torch.zeros(3)})
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = top_level(HARNESS)
    assert "graspnerf_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_reference_loads_neither_package():
    names = top_level(REFERENCE)
    assert not names & set(FORBIDDEN + ("graspnerf_tpu_torch",))


def test_run_checks_whole_names(monkeypatch):
    from bench_port import run
    monkeypatch.setitem(sys.modules, "graspnerf_tpu_torch_extra", sys)
    assert "graspnerf_tpu_torch_extra" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert run.forbidden_modules() == ["flax.core"]
